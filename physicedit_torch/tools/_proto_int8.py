"""The kernels of the int8, W4 and elementwise-rate probes and what their
tools share: T9 (``proto_int8_rate``), T10 (``proto_prefill_blocks``), T12
(``proto_w4_unpack``), T11 (``proto_w4_gemv``), T4 (``proto_attn_int8qk``)
and T6 (``proto_ew_rate``).

Each entry of :data:`VARIANTS` is a launch counter in :data:`LAUNCHES`, the
CUDA source and entry-point switch (``kernel_id``) it launches, and that
instantiation's kernel function and template arguments as ints, which
``chip_smoke.ptxas_report`` keys its registers by:

- ``csrc/proto_int8_matmul.cu``: ``gemm_wgmma_kernel<kind>`` (T9's int8 and
  bf16 products: a persistent TMA + ``wgmma`` GEMM), ``w4_wgmma_kernel<2>``
  and ``<3>`` (T10 and T12: K3's TMA + ``wgmma`` loop, with the
  sign-extending unpack into one accumulator, and with the AND-only unpack
  into two) and ``gemv_mma_kernel`` (T11: the weights as the A operand of
  int8 ``mma.sync`` against x's 8 rows, fed by TMA, K split over a
  cluster);
- ``csrc/proto_int8qk_attention.cu``: ``int8qk_hopper_kernel`` (T4 on the
  Hopper attention mainloop, an int8 ``wgmma`` QK^T) and
  ``int8qk_rowquant_kernel`` (T4's row quantize of q and k, one launch);
- ``csrc/proto_ew_scale.cu``: ``ew_scale_kernel<bf16>`` (T6).

:func:`launch_matmul`, :func:`launch_int8qk`, :func:`launch_rowquant` and
:func:`launch_ew_scale` check what the kernels take and launch them; the
tools' wrappers take
their plain versions for CPU tensors and call these for CUDA ones, which
launch or raise and never fall back.  The plain versions' integer results
are exact (``kernels/quant_matmul._exact_mm``), their fp32 steps rounded
in the kernels' order.

Weight layout: the port's own.  T9's w is ``[N, K]`` and the W4 weights are
K3's ``w4 [N, K/2]`` (``csrc/mma_int8.cuh``): one output column's k values
are contiguous, both operands K-major, as int8 ``wgmma`` and ``mma.sync``
take them.  The JAX tools hold
``[K, N]`` and ``[K/2, N]``; the tests transpose them.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import itertools
import math

import torch

from physicedit_torch.kernels import _build
from physicedit_torch.kernels import quant_matmul as qm
from physicedit_torch.tools import _bench

MATMUL = "proto_int8_matmul"
ATTENTION = "proto_int8qk_attention"
EW = "proto_ew_scale"
SOURCES = (MATMUL, ATTENTION, EW)

L2_BYTES = 50 << 20       # the H100's L2
TILE_N = 128              # the matmuls take N in whole 128-column tiles
GEMV_ROWS = 8             # the GEMV's rows (the tools' padded decode)
ATTN_BLOCK = 64           # T4's shape rule: S_q and S_k multiples of it
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@dataclasses.dataclass(frozen=True)
class Variant:
    source: str
    kernel_id: int
    kernel: str
    template_args: tuple


VARIANTS = {
    "proto_mm_i32": Variant(MATMUL, 0, "gemm_wgmma_kernel", (0,)),  # T9, acc "i32"
    "proto_mm_f32": Variant(MATMUL, 1, "gemm_wgmma_kernel", (1,)),  # T9, acc "f32"
    "proto_w4_i32": Variant(MATMUL, 2, "w4_wgmma_kernel", (2,)),    # T10
    "proto_w4_and": Variant(MATMUL, 3, "w4_wgmma_kernel", (3,)),    # T12
    "proto_w4_gemv_and": Variant(MATMUL, 4, "gemv_mma_kernel", ()),    # T11
    "proto_int8qk": Variant(ATTENTION, 0, "int8qk_hopper_kernel", ()),          # T4
    "proto_int8qk_quant": Variant(ATTENTION, 1, "int8qk_rowquant_kernel", ()),  # T4's quantize
    "proto_ew_scale_fp32": Variant(EW, 0, "ew_scale_kernel", (0,)),  # T6
    "proto_ew_scale_bf16": Variant(EW, 1, "ew_scale_kernel", (1,)),  # T6
}

LAUNCHES = dict.fromkeys(VARIANTS, 0)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Operands and plain versions
# ---------------------------------------------------------------------------

def pack_offset(w_q: torch.Tensor) -> torch.Tensor:
    """``[N, K]`` integers in [-7, 7] -> the offset-encoded nibbles ``[N,
    K/2]`` int8: byte j holds ``w[:, j] + 8`` in its low nibble and ``w[:, j
    + K/2]`` in its high one (``pack_offset`` of the JAX tools on ``[K, N]``,
    transposed; K3's packing)."""
    k2 = w_q.shape[1] // 2
    w = w_q.to(torch.int8)
    return (w[:, k2:] << 4) | ((w[:, :k2] + 8) & 0xF)


def low_half_rowsum8(x_q: torch.Tensor) -> torch.Tensor:
    """``8 * rowsum(x_q[:, :K/2])`` int32 ``[M]``: the AND-only form's
    correction for the +8 of the low nibble (``rs`` of the JAX tools, an XLA
    op outside their kernels; T12's input, and computed inside T11's
    kernel)."""
    return x_q[:, :x_q.shape[1] // 2].sum(1, dtype=torch.int32) * 8


def and_only_acc(x_q: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The AND-only form's integer result, exactly: ``x_lo . (b & 15)`` +
    ``(x_hi . (b & -16)) >> 4`` - ``8 rowsum(x_lo)``, int32 ``[M, N]``.  It
    equals ``x_q . unpack(packed)^T``."""
    k2 = packed.shape[1]
    acc = qm._exact_mm(x_q[:, :k2], packed & 15)
    acc16 = qm._exact_mm(x_q[:, k2:], packed & -16)
    return acc - low_half_rowsum8(x_q)[:, None] + (acc16 >> 4)


def w4_epilogue(acc: torch.Tensor, x_scale: torch.Tensor, wsb: torch.Tensor, out_dtype):
    """``acc * x_scale * wsb[0] + wsb[1]`` in fp32, each step rounded, then
    ``out_dtype``; int8 as JAX converts: truncate toward 0 and saturate
    (``Tensor.to(torch.int8)`` would wrap: 300 -> 44)."""
    wsb = wsb.float()
    out = acc.float() * x_scale.reshape(-1, 1).float() * wsb[0][None, :] + wsb[1][None, :]
    if out_dtype == torch.int8:
        return out.clamp(-128.0, 127.0).trunc().to(torch.int8)
    return out.to(out_dtype)


def rowquant(x: torch.Tensor):
    """T4's per-row quantizer: int8 codes ``round(x / s)`` clipped to ±127
    (half to even) and fp32 scales ``s = max(amax / 127, 1e-8)`` ``[...]``
    (``rowquant`` inside the JAX tool; a true division, as
    ``quant_matmul.true_div``)."""
    xf = x.float()
    s = qm.true_div(xf.abs().amax(-1), 127.0).clamp_min(1e-8)
    return (xf / s[..., None]).round().clamp(-127, 127).to(torch.int8), s


def int8qk_half_scale(d: int) -> torch.Tensor:
    """fp32(sqrt(log2(e) / sqrt(d))), the factor each of T4's q and k scales
    carries (a Python float in the JAX tool, so rounded to fp32 once; a 0-dim
    CPU tensor, which a CUDA graph can capture)."""
    return torch.tensor((math.log2(math.e) / d ** 0.5) ** 0.5, dtype=torch.float32)


def rowquant_scaled(q: torch.Tensor, k: torch.Tensor):
    """The plain version of T4's quantize kernel: q's and k's codes and
    scales by :func:`rowquant`, each scale times :func:`int8qk_half_scale`."""
    half_scale = int8qk_half_scale(q.shape[-1])
    qq, qs = rowquant(q)
    kq, ks = rowquant(k)
    return qq, kq, qs * half_scale, ks * half_scale


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

def _check_card(tool: str, tensors: dict) -> None:
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if (not t.is_cuda or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{tool}: {name} must be a contiguous, 16-byte aligned CUDA "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def launch_matmul(name: str, x, w, x_scale=None, wsb=None, rs=None, out_dtype=None,
                  return_acc: bool = False):
    """Instantiation ``name`` of ``csrc/proto_int8_matmul.cu`` on x ``[M,
    K]`` and w ``[N, K]`` (T9) or w4 ``[N, K/2]`` (the W4 forms), counted in
    ``LAUNCHES[name]``.  x_scale, wsb, ``out_dtype`` and ``return_acc`` are
    T10's and T12's, rs T12's alone (T11's kernel computes its own).
    Returns out ``[M, N]`` (int32 for T9 i32 and T11, bf16 for T9 f32), and
    for T10 / T12 with ``return_acc`` also their int32 accumulators.  Raises
    on a shape the kernel cannot take (M < 1, N % 128, K % 128, or K % 64 for
    T9 f32; the GEMV M > 8 or K % 32) before anything launches."""
    var = VARIANTS[name]
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x and w must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    w4 = name not in ("proto_mm_i32", "proto_mm_f32")
    tiled_w4 = name in ("proto_w4_i32", "proto_w4_and")
    in_dtype = torch.bfloat16 if name == "proto_mm_f32" else torch.int8
    tile_k = 64 if name == "proto_mm_f32" else 128
    if w.shape[1] * (2 if w4 else 1) != k or m < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit")
    if name == "proto_w4_gemv_and":
        if m > GEMV_ROWS or k % 32:
            raise ValueError(f"{name}: takes M <= {GEMV_ROWS} and K % 32 == 0, got M {m} K {k}")
    elif n % TILE_N or k % tile_k:
        raise ValueError(f"{name}: takes N % {TILE_N} == 0 and K % {tile_k} == 0, "
                         f"got N {n} K {k}")
    if (rs is None) == (name == "proto_w4_and"):
        raise ValueError(f"{name}: rs is T12's input, and T12's only")
    if not tiled_w4:
        x_scale = wsb = None
        out_dtype = torch.bfloat16 if name == "proto_mm_f32" else torch.int32
    elif wsb.shape != (2, n) or out_dtype not in OUT_CODES:
        raise ValueError(f"{name}: wsb must be [2, {n}] and out fp32, bf16 or int8, got "
                         f"{tuple(wsb.shape)} and {out_dtype}")
    else:
        x_scale = x_scale.reshape(m)
    _check_card(name, {"x": (x, in_dtype), "w": (w, in_dtype), "x_scale": (x_scale, torch.float32),
                       "wsb": (wsb, torch.float32), "rs": (rs, torch.int32)})
    return_acc = return_acc and tiled_w4
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    acc = torch.empty((m, n), dtype=torch.int32, device=x.device) if return_acc else None
    ptr = _build.ptr
    _build.launch(MATMUL, "proto_int8_matmul",
                  [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
                  var.kernel_id, ptr(x), ptr(w), ptr(x_scale), ptr(wsb), ptr(rs), ptr(out),
                  ptr(acc), OUT_CODES.get(out_dtype, 0), m, n, k)
    LAUNCHES[name] += 1
    return (out, acc) if return_acc else out


def launch_rowquant(q, k):
    """T4's quantize kernel on bf16 q ``[B, N, S_q, 128]`` and k ``[B, N,
    S_k, 128]`` in one launch: their int8 codes and their fp32 scales ``[B, N,
    S]`` times :func:`int8qk_half_scale` (:func:`rowquant_scaled`'s bits),
    counted in ``LAUNCHES["proto_int8qk_quant"]``."""
    if q.shape[-1] != 128 or k.shape[-1] != 128:
        raise ValueError(f"proto_int8qk_quant: rows of 128 only, got q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    _check_card("proto_int8qk_quant", {"q": (q, torch.bfloat16), "k": (k, torch.bfloat16)})
    qq, kq = torch.empty_like(q, dtype=torch.int8), torch.empty_like(k, dtype=torch.int8)
    qs = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    ks = torch.empty(k.shape[:-1], dtype=torch.float32, device=k.device)
    ptr = _build.ptr
    _build.launch(ATTENTION, "proto_int8qk_rowquant",
                  [ctypes.c_void_p] * 6 + [ctypes.c_long] * 2 + [ctypes.c_float],
                  ptr(q), ptr(k), ptr(qq), ptr(kq), ptr(qs), ptr(ks), qs.numel(), ks.numel(),
                  float(int8qk_half_scale(q.shape[-1])))
    LAUNCHES["proto_int8qk_quant"] += 1
    return qq, kq, qs, ks


def launch_int8qk(qq, kq, v, q_scale, k_scale, key_bias):
    """T4's kernel on int8 codes ``[B, N, S, 128]``, bf16 v, fp32 scales
    ``[B, N, S]`` (times sqrt(log2(e) / sqrt(d))) and an fp32 key bias ``[B,
    S_k]``; bf16 out, counted in ``LAUNCHES["proto_int8qk"]``.  Raises on S_q
    or S_k not a multiple of 64 before anything launches."""
    b, n, sq, d = qq.shape
    sk = kq.shape[2]
    if d != 128 or kq.shape != (b, n, sk, d) or v.shape != kq.shape:
        raise ValueError(f"proto_int8qk: q {tuple(qq.shape)}, k {tuple(kq.shape)}, v "
                         f"{tuple(v.shape)} are not [B, N, S, 128] of one B and N")
    if sq % ATTN_BLOCK or sk % ATTN_BLOCK or sk == 0:
        raise ValueError(f"proto_int8qk: S_q {sq} and S_k {sk} must be multiples of the "
                         f"{ATTN_BLOCK}-row tile")
    if q_scale.shape != (b, n, sq) or k_scale.shape != (b, n, sk) or key_bias.shape != (b, sk):
        raise ValueError(f"proto_int8qk: scales {tuple(q_scale.shape)}, "
                         f"{tuple(k_scale.shape)} and key bias {tuple(key_bias.shape)} do not "
                         f"fit q {tuple(qq.shape)} and k {tuple(kq.shape)}")
    _check_card("proto_int8qk", {"q": (qq, torch.int8), "k": (kq, torch.int8),
                                 "v": (v, torch.bfloat16), "q_scale": (q_scale, torch.float32),
                                 "k_scale": (k_scale, torch.float32),
                                 "key_bias": (key_bias, torch.float32)})
    out = torch.empty((b, n, sq, d), dtype=torch.bfloat16, device=v.device)
    ptr = _build.ptr
    _build.launch(ATTENTION, "proto_int8qk_attention_bf16",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
                  ptr(qq), ptr(kq), ptr(v), ptr(q_scale), ptr(k_scale), ptr(key_bias), ptr(out),
                  b, n, sq, sk)
    LAUNCHES["proto_int8qk"] += 1
    return out


def launch_ew_scale(x, c: float, d: float):
    """T6's kernel: ``x * c + d`` over a contiguous bf16 or fp32 x, with c and
    d already rounded to x's dtype; counted per dtype."""
    name = {torch.bfloat16: "proto_ew_scale_bf16", torch.float32: "proto_ew_scale_fp32"}.get(
        x.dtype)
    if name is None:
        raise ValueError(f"proto_ew_scale: takes bf16 or fp32, got {x.dtype}")
    _check_card(name, {"x": (x, x.dtype)})
    out = torch.empty_like(x)
    _build.launch(EW, "proto_ew_scale",
                  [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                   ctypes.c_float, ctypes.c_float],
                  VARIANTS[name].kernel_id, _build.ptr(x), _build.ptr(out), x.numel(), c, d)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# What the tools share on the card
# ---------------------------------------------------------------------------

def l2_copies(t: torch.Tensor, min_bytes: int = 2 * L2_BYTES) -> list:
    """``t`` and as many clones as make their bytes together at least
    ``min_bytes`` (twice the L2 by default), so that a call that takes the
    next copy each time finds its operand in device memory, not in L2: a
    decode reads 28 layers of weights per token, each once."""
    n = max(1, math.ceil(min_bytes / (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def rotated(fn, copies: list):
    """A callable that runs ``fn`` on the next of ``copies`` at each call and
    keeps its last ``len(copies)`` results alive, so that neither the
    operand nor the output of a call lies in L2 from the calls before it
    (an output freed at once would be written to the same lines again)."""
    it = itertools.cycle(copies)
    kept = collections.deque(maxlen=len(copies))

    def call():
        kept.append(fn(next(it)))
        return kept[-1]

    return call


def check_row(tool: str, case: str, **values) -> dict:
    """The tool's check line, printed and returned."""
    _bench.log(f"{tool} check {case}: " + ", ".join(f"{k} {v}" for k, v in values.items()))
    return {"tool": tool, "check": case, **values}
