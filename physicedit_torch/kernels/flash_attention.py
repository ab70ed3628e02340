"""The attention kernels and their plain versions.

K1 :func:`fixedmax_attention` (``csrc/fixedmax_attention.cu``) is the DiT
joint attention; it replaces ``physicedit_tpu/kernels/flash_attention.py::
_fixedmax_kernel_lse`` (entered through ``flash_attention_bnsd``).  Under
autograd it is a ``torch.autograd.Function`` (the JAX package's
``_fixedmax_diff``) whose backward is K8 :func:`fixedmax_attention_bwd`
(``csrc/fixedmax_attention_bwd.cu``), which replaces ``_fm_bwd_dq_kernel``
and ``_fm_bwd_dkv_kernel`` (launched from ``_fm_bwd``).  K7
:func:`fixedmax_attention_bias` (``csrc/fixedmax_attention_bias.cu``) is
the DiT joint attention with a head-shared 2-D bias, the EliGen entity
masks; it replaces ``_fixedmax_kernel_bias2d`` (entered through
``flash_attention_bnsd(bias=...)``).  K2 :func:`gqa_causal_attention`
(``csrc/gqa_causal_attention.cu``) is the Qwen2.5-VL prefill and
prompt-encode attention; it replaces ``_gqa_causal_kernel`` (entered through
``gqa_causal_flash``).  K10 :func:`online_attention`
(``csrc/online_attention.cu``) is the online-softmax attention (a running
max, right for unbounded logits), with an optional head-shared bias (K10b);
it replaces ``_flash_kernel`` and ``_flash_kernel_bias`` (entered through
``flash_attention_bnsd(variant="online")``).  K1' :func:`fixedmax_bnsd` is the
fixed-max attention without the row sums, q prescaled (K1's kernel) or
scaled in fp32 in the kernel (K7's kernel without its bias, the clamp
switchable); it replaces ``_fixedmax_kernel`` (entered through
``_fixedmax_bnsd``).  :func:`flash_attention_bnsd` and the BSND
:func:`flash_attention` dispatch as the JAX package's functions of those
names do.  K1, K2, K7 (with K1' scaled), K8, K10 and K10b run on the
Hopper loop of ``csrc/hopper_attention.cuh`` (TMA, ``wgmma``, a producer
and two ping-ponged consumer warpgroups), so their q, k, v (and K8's g)
must be contiguous and 16-byte aligned.  Each source file says what bounds
its kernel on the H100 and what the design does about it.

Each wrapper takes its plain PyTorch version (``*_reference``) for a tensor
that lies on the CPU.  For a CUDA tensor it launches the kernel, or raises
for what the kernel does not take (dtype other than bf16, head_dim other
than 128, non-contiguous inputs); it never falls back.  ``LAUNCHES`` counts
kernel launches, one per call that reaches a kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from physicedit_torch.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# exp2(CLAMP) * 16k keys ~ 2e34 < fp32 max: no overflow even if extreme
# trained gammas break the bounded-logits assumption
CLAMP = 100.0
HEAD_DIM = 128

LN2 = 1.0 / LOG2E   # d sig / d q' = k * ln 2 for the prescaled q' (and likewise for k)

LAUNCHES = {"fixedmax_attention": 0, "fixedmax_attention_bwd": 0,
            "fixedmax_attention_bias": 0, "gqa_causal_attention": 0,
            "online_attention": 0, "online_attention_bias": 0, "fixedmax_bnsd": 0,
            # the bf16 attention prototypes (tools/_proto_attention.VARIANTS)
            "proto_fixedmax": 0, "proto_fixedmax2": 0, "proto_fixedmax2_overlap": 0,
            "proto_nobias_inscale": 0, "proto_nobias": 0, "proto_nmask": 0,
            "proto_bf16s": 0, "proto_expnosum": 0, "proto_noexp": 0,
            "proto_interleave": 0, "proto_interleave_overlap": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """q * log2(e) / sqrt(d) in q's dtype, the scale itself rounded to that
    dtype first (``flash_attention_bnsd`` in the JAX package does the same)."""
    scale = torch.tensor(LOG2E / math.sqrt(q.shape[-1]), dtype=q.dtype).item()
    return q * scale


def _check_cuda(name: str, tensors: dict) -> None:
    for tname, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {tname} is on {t.device}, not CUDA")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {tname} is {t.dtype}; the kernel takes bf16")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}; the "
                             f"kernel takes 4-D inputs with head_dim {HEAD_DIM}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned "
                             f"(no copy is made; the Hopper kernels read it through TMA)")


def _mask_arg(key_mask: torch.Tensor | None, b: int, s: int, name: str):
    if key_mask is None:
        return None
    if key_mask.shape != (b, s) or key_mask.dtype != torch.bool:
        raise ValueError(f"{name}: key_mask must be bool [{b}, {s}], got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    return key_mask.to(torch.uint8).contiguous()


# ---------------------------------------------------------------------------
# K1: fixed-max joint attention (DiT)
# ---------------------------------------------------------------------------

def _key_bias(key_mask):
    """[B, S_k] bool -> additive [B, 1, 1, S_k] fp32 (0 live, -1e30 masked)."""
    return torch.where(key_mask, 0.0, NEG_INF).float()[:, None, None, :]


def _head_groups(n: int, sq: int, sk: int):
    """Head slices that keep an fp32 [S_q, S_k] score block near 1 GB."""
    step = max(1, (1 << 28) // max(1, sq * sk))
    return [slice(h0, min(n, h0 + step)) for h0 in range(0, n, step)]


def _fixedmax_prescaled_reference(qs, k, v, key_mask, clamp):
    """Plain K1 on the prescaled q' = q * log2(e) / sqrt(d): (out, l)."""
    b, n, sq, _ = qs.shape
    sk = k.shape[2]
    key_bias = None if key_mask is None else _key_bias(key_mask)
    out = torch.empty_like(qs)
    l_all = torch.empty((b, n, sq), dtype=torch.float32, device=qs.device)
    for bi in range(b):
        for hs in _head_groups(n, sq, sk):
            s = torch.matmul(qs[bi, hs].float(), k[bi, hs].float().transpose(-1, -2))
            if key_bias is not None:
                s = s + key_bias[bi]
            if clamp:
                s = s.clamp(max=CLAMP)
            p = torch.exp2(s)
            l = p.sum(-1)
            acc = torch.matmul(p.to(v.dtype).float(), v[bi, hs].float())
            out[bi, hs] = (acc / l.clamp(min=1e-30)[..., None]).to(qs.dtype)
            l_all[bi, hs] = l
    return out, l_all


def fixedmax_attention_reference(q, k, v, key_mask=None, clamp: bool = True,
                                 return_l: bool = False):
    """Plain version of K1 with the kernel's numerics.

    q: [B, N, S_q, D]; k/v: [B, N, S_k, D]; key_mask: [B, S_k] bool.
    p = exp2(min(q' k^T + key_bias, CLAMP)) with q' pre-scaled in q's dtype,
    fp32 row sum l, out = (p in v's dtype . v) / max(l, 1e-30) in q's dtype.
    Heads are taken in groups so the fp32 score matrix stays near 1 GB.
    Returns out, or (out, l [B, N, S_q] fp32) with ``return_l``.
    """
    out, l = _fixedmax_prescaled_reference(_prescale(q), k, v, key_mask, clamp)
    return (out, l) if return_l else out


def _fixedmax_prescaled(qs, k, v, key_mask, clamp: bool, return_l: bool):
    """K1 on the prescaled q': the plain version for CPU tensors, the kernel
    for CUDA tensors.  Returns (out, l or None)."""
    if qs.device.type == "cpu":
        out, l = _fixedmax_prescaled_reference(qs, k, v, key_mask, clamp)
        return out, (l if return_l else None)
    _check_cuda("fixedmax_attention", {"q": qs, "k": k, "v": v})
    b, n, sq, _ = qs.shape
    sk = k.shape[2]
    if k.shape != (b, n, sk, HEAD_DIM) or v.shape != k.shape:
        raise ValueError(f"fixedmax_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(qs.shape)}")
    mask = _mask_arg(key_mask, b, sk, "fixedmax_attention")
    out = torch.empty_like(qs)
    l = torch.empty((b, n, sq), dtype=torch.float32, device=qs.device) if return_l else None
    ptr = _build.ptr
    _build.launch("fixedmax_attention", "fixedmax_attention_bf16",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
                  ptr(qs), ptr(k), ptr(v), ptr(mask), ptr(out), ptr(l),
                  b, n, sq, sk, int(bool(clamp)))
    LAUNCHES["fixedmax_attention"] += 1
    return out, l


class _FixedMaxAttention(torch.autograd.Function):
    """Differentiable K1 on the prescaled q' (the JAX package's
    ``_fixedmax_diff`` with ``prescaled=True``).  The backward is K8; it
    returns the gradient with respect to q', and autograd's multiply by the
    prescale gives the one with respect to q.  The key mask takes no
    gradient."""

    @staticmethod
    def forward(ctx, qs, k, v, key_mask, clamp):
        out, l = _fixedmax_prescaled(qs, k, v, key_mask, clamp, return_l=True)
        ctx.save_for_backward(qs, k, v, out, l)
        ctx.key_mask, ctx.clamp = key_mask, clamp
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, out, l = ctx.saved_tensors
        dq, dk, dv = fixedmax_attention_bwd(qs, k, v, ctx.key_mask, g.contiguous(), out, l,
                                            ctx.clamp)
        return dq, dk, dv, None, None


def fixedmax_attention(q, k, v, key_mask=None, clamp: bool = True,
                       return_l: bool = False):
    """K1: fixed-max attention, [B, N, S_q, D] x [B, N, S_k, D] -> [B, N, S_q, D].

    No running max: the DiT RMS-norms q and k, so the logits are bounded
    (``models/dit.attn_clamp_needed`` decides ``clamp`` at load).  S_q may be
    shorter than S_k (the slim last block).  Masked keys contribute nothing;
    a row whose keys are all masked returns 0.  With grad enabled and q, k or
    v requiring grad, the call is differentiable through K8.
    """
    qs = _prescale(q)
    if q.device.type != "cpu":
        qs = qs.contiguous()
    if not return_l and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _FixedMaxAttention.apply(qs, k, v, key_mask, clamp)
    out, l = _fixedmax_prescaled(qs, k, v, key_mask, clamp, return_l)
    return (out, l) if return_l else out


# ---------------------------------------------------------------------------
# K8: the fixed-max attention backward
# ---------------------------------------------------------------------------

def attention_bwd_rowdot(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(g * out) in fp32, [B, N, S_q] (the JAX wrapper's ``dd``)."""
    return (g.float() * out.float()).sum(-1)


def fixedmax_attention_bwd_reference(qs, k, v, key_mask, g, out, l, clamp: bool = True):
    """Plain version of K8, with the kernel's numerics (``_fm_bwd`` with
    ``prescaled=True``): P = exp2(min(q' k^T + key_bias, CLAMP)) /
    max(l, 1e-30) recomputed in fp32, dS = P * (g v^T - D), zero where the
    clamp bound, dq' = bf16(dS) . k * ln2, dk = bf16(dS)^T . q' * ln2,
    dv = bf16(P)^T . g, fp32 sums, each cast to its input's dtype."""
    b, n, sq, _ = qs.shape
    sk = k.shape[2]
    key_bias = None if key_mask is None else _key_bias(key_mask)
    dd = attention_bwd_rowdot(g, out)
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for hs in _head_groups(n, sq, sk):
            qf, kf = qs[bi, hs].float(), k[bi, hs].float()
            sig = torch.matmul(qf, kf.transpose(-1, -2))
            if key_bias is not None:
                sig = sig + key_bias[bi]
            p = torch.exp2(sig.clamp(max=CLAMP) if clamp else sig)
            p = p * (1.0 / l[bi, hs].clamp(min=1e-30))[..., None]
            dp = torch.matmul(g[bi, hs].float(), v[bi, hs].float().transpose(-1, -2))
            ds = p * (dp - dd[bi, hs][..., None])
            if clamp:
                ds = torch.where(sig < CLAMP, ds, 0.0)
            ds_lo = ds.to(k.dtype).float()
            dq[bi, hs] = (torch.matmul(ds_lo, kf) * LN2).to(qs.dtype)
            dk[bi, hs] = (torch.matmul(ds_lo.transpose(-1, -2), qf) * LN2).to(k.dtype)
            dv[bi, hs] = torch.matmul(p.to(g.dtype).float().transpose(-1, -2),
                                      g[bi, hs].float()).to(v.dtype)
    return dq, dk, dv


def fixedmax_attention_bwd(qs, k, v, key_mask, g, out, l, clamp: bool = True):
    """K8: the gradients (dq', dk, dv) of K1 on the prescaled q', given the
    output gradient g, K1's output and its row sums l.

    The plain version for CPU tensors; for CUDA tensors the kernel: bf16
    q'/k/v/g/out [B, N, S, 128] (S_q may be shorter than S_k), fp32 l; D is
    formed here in fp32 and the kernel's dq and dk/dv passes read it.
    """
    if qs.device.type == "cpu":
        return fixedmax_attention_bwd_reference(qs, k, v, key_mask, g, out, l, clamp)
    _check_cuda("fixedmax_attention_bwd", {"q": qs, "k": k, "v": v, "g": g, "out": out})
    b, n, sq, _ = qs.shape
    sk = k.shape[2]
    if (k.shape != (b, n, sk, HEAD_DIM) or v.shape != k.shape or g.shape != qs.shape
            or out.shape != qs.shape):
        raise ValueError(f"fixedmax_attention_bwd: shapes q {tuple(qs.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} g {tuple(g.shape)} "
                         f"out {tuple(out.shape)} do not fit")
    if l.dtype != torch.float32 or l.shape != (b, n, sq) or not l.is_contiguous():
        raise ValueError(f"fixedmax_attention_bwd: l must be contiguous fp32 "
                         f"[{b}, {n}, {sq}], got {l.dtype} {tuple(l.shape)}")
    mask = _mask_arg(key_mask, b, sk, "fixedmax_attention_bwd")
    dd = attention_bwd_rowdot(g, out)
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    ptr = _build.ptr
    _build.launch("fixedmax_attention_bwd", "fixedmax_attention_bwd_bf16",
                  [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5,
                  ptr(qs), ptr(k), ptr(v), ptr(mask), ptr(g), ptr(l), ptr(dd),
                  ptr(dq), ptr(dk), ptr(dv), b, n, sq, sk, int(bool(clamp)))
    LAUNCHES["fixedmax_attention_bwd"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# K7: fixed-max joint attention with a head-shared 2-D bias (EliGen)
# ---------------------------------------------------------------------------

def bias_log2(attn_bias: torch.Tensor) -> torch.Tensor:
    """An additive attention bias in exp2 units, the form K7 takes: fp32
    ``attn_bias * log2(e)``, the multiply ``flash_attention_bnsd`` makes
    before each call (the pipeline makes it once per edit)."""
    return attn_bias.float() * LOG2E


def _fixedmax_scaled_reference(q, k, v, bias, key_mask, clamp: bool):
    """Fixed-max attention with q scaled in fp32: s = fp32(q k^T) *
    (log2(e) / sqrt(d)) [+ bias] + key_bias, p = exp2(min(s, CLAMP) if
    clamp), fp32 row sum l, out = (p in v's dtype . v) / max(l, 1e-30)."""
    b, n, sq, d = q.shape
    sk = k.shape[2]
    scale = LOG2E / math.sqrt(d)
    key_bias = None if key_mask is None else _key_bias(key_mask)
    out = torch.empty_like(q)
    for bi in range(b):
        for hs in _head_groups(n, sq, sk):
            s = torch.matmul(q[bi, hs].float(), k[bi, hs].float().transpose(-1, -2)).mul_(scale)
            if bias is not None:
                s.add_(bias[bi])
            if key_bias is not None:
                s.add_(key_bias[bi])
            p = torch.exp2(s.clamp_(max=CLAMP) if clamp else s)
            l = p.sum(-1)
            acc = torch.matmul(p.to(v.dtype).float(), v[bi, hs].float())
            out[bi, hs] = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out


def fixedmax_attention_bias_reference(q, k, v, bias, key_mask=None):
    """Plain version of K7 with the kernel's numerics (the JAX package's
    ``_fixedmax_kernel_bias2d``).

    q: [B, N, S_q, D]; k/v: [B, N, S_k, D]; bias: [B, S_q, S_k] fp32 in exp2
    units (:func:`bias_log2`), shared by the heads; key_mask:
    [B, S_k] bool.  s = fp32(q k^T) * (log2(e) / sqrt(d)) + bias + key_bias,
    p = exp2(min(s, CLAMP)) (the clamp is always on), fp32 row sum l,
    out = (p in v's dtype . v) / max(l, 1e-30) in q's dtype.
    """
    return _fixedmax_scaled_reference(q, k, v, bias, key_mask, clamp=True)


def _check_forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward only (the JAX package's kernel has no VJP)")


def _check_bias(name: str, bias, b: int, sq: int, sk: int) -> None:
    if (not bias.is_cuda or bias.dtype != torch.float32 or bias.shape != (b, sq, sk)
            or bias.stride(-1) != 1):
        raise ValueError(f"{name}: bias must be fp32 [{b}, {sq}, {sk}] on the card with a "
                         f"contiguous last dim, got {bias.dtype} {tuple(bias.shape)} "
                         f"strides {bias.stride()} on {bias.device}")


def _check_qkv(name: str, q, k, v, sq_le_sk: bool = False):
    _check_cuda(name, {"q": q, "k": k, "v": v})
    b, n, sq, _ = q.shape
    sk = k.shape[2]
    if k.shape != (b, n, sk, HEAD_DIM) or v.shape != k.shape or (sq_le_sk and sq > sk):
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}" + (" (S_q <= S_k)" if sq_le_sk else ""))
    return b, n, sq, sk


def fixedmax_attention_bias(q, k, v, bias, key_mask=None):
    """K7: fixed-max attention with a head-shared additive bias,
    [B, N, S_q, D] x [B, N, S_k, D] -> [B, N, S_q, D].

    ``bias`` is fp32 [B, S_q, S_k] in exp2 units (:func:`bias_log2`); its
    last dim must be contiguous, and its rows may be a view with any row pitch
    and batch stride (the slim last block reads ``bias[:, s_t:s_t + base]``).
    q is scaled in fp32 inside the kernel and the clamp is always on, as the
    JAX package routes a biased call whatever its ``clamp``.  S_q <= S_k.  A
    row whose keys are all blocked returns 0.  Forward only: a call that
    needs a gradient raises, as the JAX package has no VJP for it.
    """
    if bias is None:
        raise ValueError("fixedmax_attention_bias needs a bias (without one, use "
                         "fixedmax_attention)")
    _check_forward_only("fixedmax_attention_bias", q, k, v, bias)
    if q.device.type == "cpu":
        return fixedmax_attention_bias_reference(q, k, v, bias, key_mask)
    b, n, sq, sk = _check_qkv("fixedmax_attention_bias", q, k, v, sq_le_sk=True)
    _check_bias("fixedmax_attention_bias", bias, b, sq, sk)
    mask = _mask_arg(key_mask, b, sk, "fixedmax_attention_bias")
    out = torch.empty_like(q)
    ptr = _build.ptr
    _build.launch("fixedmax_attention_bias", "fixedmax_attention_bias_bf16",
                  [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 4 + [ctypes.c_float],
                  ptr(q), ptr(k), ptr(v), ptr(bias), bias.stride(0), bias.stride(1), ptr(mask), ptr(out),
                  b, n, sq, sk, LOG2E / math.sqrt(HEAD_DIM))
    LAUNCHES["fixedmax_attention_bias"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: causal GQA attention (Qwen2.5-VL prefill / prompt encode)
# ---------------------------------------------------------------------------

def gqa_causal_attention_reference(q, k, v, key_mask):
    """Plain version of K2: dense causal GQA with an fp32 softmax.

    q: [B, S, N, D]; k/v: [B, S, KV, D]; key_mask: [B, S] bool.  Returns
    [B, S, N * D].  Rows with no live key (left-pad queries) are not
    defined by the contract; compare live rows only.
    """
    from physicedit_torch.ops.attention import causal_bias, gqa_attention

    return gqa_attention(q, k, v, causal_bias(key_mask))


def gqa_causal_attention(q, k, v, key_mask):
    """K2: causal GQA attention over [B, S, heads, D] inputs -> [B, S, N * D].

    Query head h reads K/V head h // (N / KV); causality is by absolute
    position and ``key_mask`` (True = live) excludes padded keys, so left-
    and right-padded batches both work.  Rows with no live key come out 0.
    """
    if q.device.type == "cpu":
        return gqa_causal_attention_reference(q, k, v, key_mask)
    _check_cuda("gqa_causal_attention", {"q": q, "k": k, "v": v})
    b, s, n, _ = q.shape
    kv = k.shape[2]
    if k.shape != (b, s, kv, HEAD_DIM) or v.shape != k.shape or n % kv:
        raise ValueError(f"gqa_causal_attention: k/v {tuple(k.shape)} do not "
                         f"group onto q {tuple(q.shape)}")
    mask = _mask_arg(key_mask, b, s, "gqa_causal_attention")
    out = torch.empty((b, s, n * HEAD_DIM), dtype=q.dtype, device=q.device)
    ptr = _build.ptr
    _build.launch("gqa_causal_attention", "gqa_causal_attention_bf16",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
                  ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), b, s, n, kv)
    LAUNCHES["gqa_causal_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K1': fixed-max attention without the row sums (the JAX package's
# ``_fixedmax_bnsd``)
# ---------------------------------------------------------------------------

def fixedmax_bnsd_reference(q, k, v, key_mask=None, clamp: bool = True,
                            prescaled: bool = False):
    """Plain version of K1' with the kernel's numerics.  ``prescaled``: q
    arrives as q' = q * log2(e) / sqrt(d) (K1's arithmetic, without l);
    otherwise q is scaled in fp32 after the product (K7's arithmetic without
    a bias).  ``clamp`` switches the min(., CLAMP) on or off."""
    if prescaled:
        return _fixedmax_prescaled_reference(q, k, v, key_mask, clamp)[0]
    return _fixedmax_scaled_reference(q, k, v, None, key_mask, clamp)


def fixedmax_bnsd(q, k, v, key_mask=None, clamp: bool = True, prescaled: bool = False):
    """K1': fixed-max attention, [B, N, S_q, D] x [B, N, S_k, D] ->
    [B, N, S_q, D], forward only (the JAX package's ``_fixedmax_bnsd`` has no
    VJP).  ``prescaled=True`` takes q' = q * log2(e) / sqrt(d) and runs K1's
    kernel without its row sums; ``prescaled=False`` scales q in fp32 inside
    K7's kernel, instantiated without the bias and with the clamp as
    ``clamp`` says.  Masked keys take no weight; a row whose keys are all
    masked returns 0."""
    _check_forward_only("fixedmax_bnsd", q, k, v)
    if q.device.type == "cpu":
        return fixedmax_bnsd_reference(q, k, v, key_mask, clamp, prescaled)
    b, n, sq, sk = _check_qkv("fixedmax_bnsd", q, k, v)
    mask = _mask_arg(key_mask, b, sk, "fixedmax_bnsd")
    out = torch.empty_like(q)
    ptr = _build.ptr
    if prescaled:
        _build.launch("fixedmax_attention", "fixedmax_attention_bf16",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
                      ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), ptr(None),
                      b, n, sq, sk, int(bool(clamp)))
    else:
        _build.launch("fixedmax_attention_bias", "fixedmax_attention_scaled_bf16",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float],
                      ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), b, n, sq, sk,
                      int(bool(clamp)), LOG2E / math.sqrt(HEAD_DIM))
    LAUNCHES["fixedmax_bnsd"] += 1
    return out


# ---------------------------------------------------------------------------
# K10 / K10b: online-softmax attention, with an optional head-shared bias
# ---------------------------------------------------------------------------

ONLINE_BLOCK_K = 128    # the key tile of csrc/online_attention.cu (hopper::kTile)


def online_attention_reference(q, k, v, key_mask=None, bias=None):
    """Plain version of K10 (K10b with ``bias``) with the kernel's numerics.

    q: [B, N, S_q, D]; k/v: [B, N, S_k, D]; key_mask: [B, S_k] bool; bias:
    [B, S_q, S_k] in natural-log units, shared by the heads.  In exp2 units,
    key tile by key tile of ``ONLINE_BLOCK_K`` keys as the kernel walks them:
    x = fp32(q k^T) * (log2(e) / sqrt(d)) + bias * log2(e); a masked key, or
    one whose x is below -5e29 (a -1e30 bias), takes no weight; the running
    row max m takes the tile's max, the fp32 row sum l and accumulator are
    rescaled by exp2(m_old - m), p = exp2(x - m) is rounded to v's dtype for
    the product with v; out = acc / max(l, 1e-30) in q's dtype.  A row with
    no live key returns 0.
    """
    b, n, sq, d = q.shape
    sk = k.shape[2]
    scale = LOG2E / math.sqrt(d)
    out = torch.empty_like(q)
    for bi in range(b):
        qf = q[bi].float()
        m = torch.full((n, sq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((n, sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((n, sq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, ONLINE_BLOCK_K):
            k1 = min(sk, k0 + ONLINE_BLOCK_K)
            x = torch.matmul(qf, k[bi, :, k0:k1].float().transpose(-1, -2)).mul_(scale)
            if bias is not None:
                x.add_(bias[bi, :, k0:k1].float() * LOG2E)
            if key_mask is not None:
                x.masked_fill_(~key_mask[bi, k0:k1].bool(), NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(x > 0.5 * NEG_INF, torch.exp2(x - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                        v[bi, :, k0:k1].float())
            m = m_new
        out[bi] = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out


def online_attention(q, k, v, key_mask=None, bias=None):
    """K10 (K10b with ``bias``): online-softmax attention, [B, N, S_q, D] x
    [B, N, S_k, D] -> [B, N, S_q, D], forward only (the JAX package's
    ``_flash_bnsd`` has no VJP).

    A running max keeps it right for logits of any size.  ``bias`` is fp32
    [B, S_q, S_k] in natural-log units (the JAX package's form), its last dim
    contiguous; its rows may be a view with any row pitch and batch stride.
    Any S_q against any S_k.  A row with no live key returns 0.
    """
    _check_forward_only("online_attention", q, k, v, bias)
    if q.device.type == "cpu":
        return online_attention_reference(q, k, v, key_mask, bias)
    b, n, sq, sk = _check_qkv("online_attention", q, k, v)
    mask = _mask_arg(key_mask, b, sk, "online_attention")
    out = torch.empty_like(q)
    ptr = _build.ptr
    scale = LOG2E / math.sqrt(HEAD_DIM)
    if bias is None:
        _build.launch("online_attention", "online_attention_bf16",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float],
                      ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), b, n, sq, sk, scale)
        LAUNCHES["online_attention"] += 1
        return out
    _check_bias("online_attention", bias, b, sq, sk)
    _build.launch("online_attention", "online_attention_bias_bf16",
                  [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 4 + [ctypes.c_float],
                  ptr(q), ptr(k), ptr(v), ptr(bias), bias.stride(0), bias.stride(1), ptr(mask),
                  ptr(out), b, n, sq, sk, scale)
    LAUNCHES["online_attention_bias"] += 1
    return out


# ---------------------------------------------------------------------------
# The JAX package's entry points
# ---------------------------------------------------------------------------

VARIANTS = ("fixedmax", "online")


def flash_attention_bnsd(q, k, v, key_mask=None, bias=None, variant: str = "fixedmax",
                         clamp: bool = True):
    """Heads-major attention, q/k/v [B, N, S, D] -> [B, N, S_q, D], with the
    JAX package's dispatch: ``variant="fixedmax"`` without a bias is K1
    (differentiable through K8), with a bias K7 (which always clamps);
    ``variant="online"`` is K10, or K10b with a bias.  ``bias`` is an
    additive head-shared [B, S_q, S_k] in natural-log units."""
    if variant == "fixedmax":
        if bias is None:
            return fixedmax_attention(q, k, v, key_mask, clamp)
        return fixedmax_attention_bias(q, k, v, bias_log2(bias), key_mask)
    if variant == "online":
        return online_attention(q, k, v, key_mask, bias)
    raise ValueError(f"unknown attention variant {variant!r}; known: {VARIANTS}")


def flash_attention(q, k, v, key_mask=None, bias=None, variant: str = "fixedmax"):
    """BSND attention, q/k/v [B, S, N, D] -> [B, S, N, D] (the JAX package's
    ``flash_attention``): a bias, or a head_dim that is not a multiple of
    128, goes to the dense ``ops.attention.sdpa_xla`` as there; everything
    else to :func:`flash_attention_bnsd`, whose kernels raise on what they do
    not take (a dtype other than bf16, a head_dim other than 128)."""
    if bias is not None or q.shape[-1] % 128 != 0:
        from physicedit_torch.ops.attention import sdpa_xla

        return sdpa_xla(q, k, v, key_mask=key_mask, bias=bias)
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return flash_attention_bnsd(q, k, v, key_mask, variant=variant).transpose(1, 2)
