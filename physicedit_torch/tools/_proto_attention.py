"""The kernel family of the bf16 attention prototypes
(``csrc/proto_fixedmax_attention.cu``) and its plain version, shared by the
tools that drive them: ``proto_fixedmax`` (T7), ``proto_fixedmax2`` (T8),
``proto_attn_fast`` (T2, T3), ``proto_attn_bf16s`` (T1 v1-v4) and
``proto_attn_interleave`` (T5).

Each entry of :data:`VARIANTS` is a launch counter in
``kernels/flash_attention.LAUNCHES``, the kernel instantiation it launches
(T3 shares T2's; the two names of T8 and of T5 one each) and its switches,
which :func:`reference` follows with the kernel's numerics: fp32 scores,
exp2, P rounded to V's dtype before the product with V, fp32 row sums and
accumulator, the key tiles walked in the kernel's order (:data:`BLOCK_K`).
All of them run on the Hopper mainloop of ``csrc/hopper_attention.cuh``
(TMA, ``wgmma``).  :func:`run` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (bf16, head_dim 128, contiguous and
16-byte aligned), or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from physicedit_torch.kernels import _build
from physicedit_torch.kernels import flash_attention as fa

SOURCE = "proto_fixedmax_attention"
# the Hopper mainloop's key tile (hopper::kTile): the plain version sums over
# the same tiles
BLOCK_K = 128
BIAS_CODES = {"none": 0, "fp32": 1, "bf16": 2}
# JAX's exp2 is exp(ln 2 * x) with ln 2 in x's dtype (``lax._exp2_lower``):
# on T1 v1's bf16 scores, ln 2 rounded to bf16
LN2_BF16 = 0.69140625
NORM_CODES = {"recip": 0, "floor": 1, "none": 2}


@dataclasses.dataclass(frozen=True)
class Variant:
    """The switches of one instantiation; ``kernel_id`` selects it in the C
    entry point.

    inscale: s = fp32(q k^T) * log2(e) / sqrt(d) (else q arrives prescaled).
    bias: "fp32" adds the key bias to s (after the scale) on the keys before
    ``bias_keys``; "bf16" (T1 v1) rounds the score and its sum with the bias
    (itself rounded to bf16) to bf16, and takes exp2 as JAX does on bf16:
    bf16(exp(bf16(x * bf16(ln 2)))).  clamp: min(., 100) before exp2.  exp: p =
    exp2(.), else the score itself.  row_sum: l = sum(p).  norm: "recip" is
    acc * (1 / l) with no floor (NaN where l == 0), "floor" acc / max(l -
    n_masked, 1e-30) (0 there), "none" acc."""
    kernel_id: int
    inscale: bool = False
    bias: str = "none"
    clamp: bool = False
    exp: bool = True
    row_sum: bool = True
    norm: str = "floor"

    def template_args(self) -> tuple:
        """``proto_hopper_kernel``'s template arguments as ints: <kInScale,
        kBias, kClamp, kExp, kRowSum, kNorm>."""
        return (int(self.inscale), BIAS_CODES[self.bias], int(self.clamp), int(self.exp),
                int(self.row_sum), NORM_CODES[self.norm])


VARIANTS = {
    # T7 tools/proto_fixedmax.py::fixedmax_bnsd
    "proto_fixedmax": Variant(0, inscale=True, bias="fp32", clamp=True, norm="recip"),
    # T8 tools/proto_fixedmax2.py::fixedmax2_bnsd, sub = 1 and sub > 1: one
    # instantiation under two ids (the ping-pong already overlaps one
    # warpgroup's exp2 with the other's products)
    "proto_fixedmax2": Variant(1, bias="fp32", clamp=True, norm="recip"),
    "proto_fixedmax2_overlap": Variant(2, bias="fp32", clamp=True, norm="recip"),
    # T2 tools/proto_attn_fast.py::attn_nobias, inscale on and off (off is T1 v2)
    "proto_nobias_inscale": Variant(3, inscale=True),
    "proto_nobias": Variant(4),
    # T3 tools/proto_attn_fast.py::attn_nmask: T2's instantiation with n_masked
    "proto_nmask": Variant(4),
    # T1 tools/proto_attn_bf16s.py: v1 _bf16s_kernel, v3 _expnosum_kernel, v4 _noexp_kernel
    "proto_bf16s": Variant(5, bias="bf16"),
    "proto_expnosum": Variant(6, row_sum=False, norm="none"),
    "proto_noexp": Variant(7, exp=False, row_sum=False, norm="none"),
    # T5 tools/proto_attn_interleave.py::attn_interleaved, sub = 1 and sub > 1:
    # one instantiation under two ids, as T8's
    "proto_interleave": Variant(8, bias="fp32", norm="recip"),
    "proto_interleave_overlap": Variant(9, bias="fp32", norm="recip"),
}


def _key_bias(var: Variant, key_bias, b: int, sk: int, bias_keys: int):
    """The [B, S_k] fp32 key bias the kernel reads (bf16 values for T1 v1),
    or None where the variant takes none or ``bias_keys`` is 0."""
    if var.bias == "none" or bias_keys <= 0:
        return None
    if key_bias is None or key_bias.numel() != b * sk:
        raise ValueError(f"a key bias of {b} x {sk} values is needed, got "
                         f"{None if key_bias is None else tuple(key_bias.shape)}")
    bias = key_bias.reshape(b, sk)
    if var.bias == "bf16":
        bias = bias.to(torch.bfloat16)
    return bias.float()


def _tile_padded(bias, b: int, sk: int, bias_keys: int, device) -> torch.Tensor:
    """The kernel's key bias: [B, whole 128-key tiles] fp32, 0 from
    ``bias_keys`` and from S_k on (adding 0 to T1 v1's bf16 score changes
    nothing; the fp32 bias is copied only for the tiles below
    ``bias_keys``, and the zeros cover the rest of the last of them), so
    each tile's bias is one 512-byte copy that stays in bounds."""
    width = -(-sk // BLOCK_K) * BLOCK_K
    padded = torch.zeros((b, width), dtype=torch.float32, device=device)
    if bias is not None:
        n = min(bias_keys, sk)
        padded[:, :n] = bias[:, :n]
    return padded


def kernel_key_bias(name: str, key_bias, b: int, sk: int, bias_keys: int, device):
    """The key bias that instantiation ``name`` reads on the card: None
    (no bias, or an fp32 bias with ``bias_keys`` 0: the kernel then copies
    none), else the tile-padded [B, whole 128-key tiles] of
    :func:`_tile_padded` (always for T1 v1, whose kernel reads every
    tile's)."""
    var = VARIANTS[name]
    bias = _key_bias(var, key_bias, b, sk, bias_keys)
    if bias is None and var.bias != "bf16":
        return None
    return _tile_padded(bias, b, sk, bias_keys, device)


def reference(name: str, q, k, v, key_bias=None, bias_keys: int = 0, n_masked=None):
    """The plain version of instantiation ``name`` with the kernel's numerics.

    q: [B, N, S_q, D] (prescaled where the variant is not ``inscale``);
    k/v: [B, N, S_k, D]; key_bias: [B, 1, S_k] (or [B, S_k]), added on the
    keys before ``bias_keys``; n_masked: [B] fp32, subtracted from l before
    the floor.  Returns [B, N, S_q, D] in q's dtype."""
    var = VARIANTS[name]
    b, n, sq, d = q.shape
    sk = k.shape[2]
    bias = _key_bias(var, key_bias, b, sk, bias_keys)
    if bias is not None:
        keys = torch.arange(sk, device=bias.device)
        bias = torch.where(keys < bias_keys, bias, 0.0)[:, None, None, :]
    scale = fa.LOG2E / math.sqrt(d)
    qf = q.float()
    l = torch.zeros((b, n, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        k1 = min(sk, k0 + BLOCK_K)
        x = torch.matmul(qf, k[:, :, k0:k1].float().transpose(-1, -2))
        with_bias = bias is not None and k0 < bias_keys
        if var.bias == "bf16":
            x = x.bfloat16().float()
            if with_bias:
                x = (x + bias[..., k0:k1]).bfloat16().float()
            x = torch.exp((x * LN2_BF16).bfloat16().float()).bfloat16().float()
        else:
            if var.inscale:
                x = x * scale
            if with_bias:
                x = x + bias[..., k0:k1]
            if var.clamp:
                x = x.clamp(max=fa.CLAMP)
            if var.exp:
                x = torch.exp2(x)
        if var.row_sum:
            l += x.sum(-1)
        acc += torch.matmul(x.to(v.dtype).float(), v[:, :, k0:k1].float())
    if var.norm == "recip":
        acc = acc * l.reciprocal()[..., None]
    elif var.norm == "floor":
        if n_masked is not None:
            l = l - n_masked.float()[:, None, None]
        acc = acc / l.clamp(min=1e-30)[..., None]
    return acc.to(q.dtype)


def run(name: str, q, k, v, key_bias=None, bias_keys: int = 0, n_masked=None):
    """Instantiation ``name`` of the kernel on CUDA tensors (counted in
    ``LAUNCHES[name]``), its plain version (:func:`reference`) on CPU
    tensors.  Forward only."""
    fa._check_forward_only(name, q, k, v)
    if q.device.type == "cpu":
        return reference(name, q, k, v, key_bias, bias_keys, n_masked)
    var = VARIANTS[name]
    b, n, sq, sk = fa._check_qkv(name, q, k, v)
    if bias_keys < 0:
        raise ValueError(f"{name}: bias_keys must be >= 0, got {bias_keys}")
    bias = kernel_key_bias(name, key_bias, b, sk, bias_keys, q.device)
    nm = None
    if n_masked is not None:
        if n_masked.shape != (b,):
            raise ValueError(f"{name}: n_masked must be [{b}], got {tuple(n_masked.shape)}")
        nm = n_masked.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    ptr = _build.ptr
    _build.launch(SOURCE, "proto_fixedmax_attention_bf16",
                  [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float],
                  var.kernel_id, ptr(q), ptr(k), ptr(v), ptr(bias), ptr(nm), ptr(out),
                  b, n, sq, sk, int(bias_keys), fa.LOG2E / math.sqrt(fa.HEAD_DIM))
    fa.LAUNCHES[name] += 1
    return out


def mask_bias(key_mask) -> torch.Tensor:
    """[B, S] bool (True = live) -> the [B, 1, S] fp32 key bias the JAX
    tools build: 0 for a live key, -1e30 for a masked one."""
    return torch.where(key_mask, 0.0, fa.NEG_INF).float()[:, None, :]


def max_abs_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def dit_inputs(gen, std: float, s: int = 8448, b: int = 2, n: int = 24, d: int = 128):
    """q, k, v [B, N, S, D] bf16, normal times ``std``, on the generator's
    device: the DiT's joint attention as the JAX tools time it."""
    return tuple((torch.randn(b, n, s, d, device=gen.device, generator=gen) * std).bfloat16()
                 for _ in range(3))
