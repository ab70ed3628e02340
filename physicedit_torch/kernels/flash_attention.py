"""The two attention kernels of the main path and their plain versions.

K1 :func:`fixedmax_attention` (``csrc/fixedmax_attention.cu``) is the DiT
joint attention; it replaces ``physicedit_tpu/kernels/flash_attention.py::
_fixedmax_kernel_lse`` (entered through ``flash_attention_bnsd``).  K2
:func:`gqa_causal_attention` (``csrc/gqa_causal_attention.cu``) is the
Qwen2.5-VL prefill and prompt-encode attention; it replaces
``_gqa_causal_kernel`` (entered through ``gqa_causal_flash``).  Each source
file says what bounds its kernel on the H100 and what the design does about
it.

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

LAUNCHES = {"fixedmax_attention": 0, "gqa_causal_attention": 0}


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
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")


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

def fixedmax_attention_reference(q, k, v, key_mask=None, clamp: bool = True,
                                 return_l: bool = False):
    """Plain version of K1 with the kernel's numerics.

    q: [B, N, S_q, D]; k/v: [B, N, S_k, D]; key_mask: [B, S_k] bool.
    p = exp2(min(q' k^T + key_bias, CLAMP)) with q' pre-scaled in q's dtype,
    fp32 row sum l, out = (p in v's dtype . v) / max(l, 1e-30) in q's dtype.
    Heads are taken in groups so the fp32 score matrix stays near 1 GB.
    Returns out, or (out, l [B, N, S_q] fp32) with ``return_l``.
    """
    b, n, sq, d = q.shape
    sk = k.shape[2]
    qs = _prescale(q)
    key_bias = None
    if key_mask is not None:
        key_bias = torch.where(key_mask, 0.0, NEG_INF).float()[:, None, None, :]
    out = torch.empty_like(q)
    l_all = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    step = max(1, (1 << 28) // max(1, sq * sk))
    for bi in range(b):
        for h0 in range(0, n, step):
            hs = slice(h0, min(n, h0 + step))
            s = torch.matmul(qs[bi, hs].float(), k[bi, hs].float().transpose(-1, -2))
            if key_bias is not None:
                s = s + key_bias[bi]
            if clamp:
                s = s.clamp(max=CLAMP)
            p = torch.exp2(s)
            l = p.sum(-1)
            acc = torch.matmul(p.to(v.dtype).float(), v[bi, hs].float())
            out[bi, hs] = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
            l_all[bi, hs] = l
    return (out, l_all) if return_l else out


def fixedmax_attention(q, k, v, key_mask=None, clamp: bool = True,
                       return_l: bool = False):
    """K1: fixed-max attention, [B, N, S_q, D] x [B, N, S_k, D] -> [B, N, S_q, D].

    No running max: the DiT RMS-norms q and k, so the logits are bounded
    (``models/dit.attn_clamp_needed`` decides ``clamp`` at load).  S_q may be
    shorter than S_k (the slim last block).  Masked keys contribute nothing;
    a row whose keys are all masked returns 0.
    """
    if q.device.type == "cpu":
        return fixedmax_attention_reference(q, k, v, key_mask, clamp, return_l)
    _check_cuda("fixedmax_attention", {"q": q, "k": k, "v": v})
    b, n, sq, _ = q.shape
    sk = k.shape[2]
    if k.shape != (b, n, sk, HEAD_DIM) or v.shape != k.shape:
        raise ValueError(f"fixedmax_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    mask = _mask_arg(key_mask, b, sk, "fixedmax_attention")
    qs = _prescale(q).contiguous()
    out = torch.empty_like(q)
    l = torch.empty((b, n, sq), dtype=torch.float32, device=q.device) if return_l else None
    ptr = _build.ptr
    _build.launch("fixedmax_attention", "fixedmax_attention_bf16",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
                  ptr(qs), ptr(k), ptr(v), ptr(mask), ptr(out), ptr(l),
                  b, n, sq, sk, int(bool(clamp)))
    LAUNCHES["fixedmax_attention"] += 1
    return (out, l) if return_l else out


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
