"""The W4A8 lane: packed-int4 weights, int8 activations
(``physicedit_tpu/kernels/quant_matmul.py``), and kernels K3 and K9.

Weights are quantized per output channel, symmetric to [-7, 7], and packed
two to a byte along the contraction axis exactly as the JAX package packs
them: byte j of output column n holds ``w[j, n] + 8`` in its low nibble and
``w[j + K/2, n]`` in its high nibble.  The port stores that array as
``w4 [N, K/2]`` (the JAX package's ``[K/2, N]`` transposed: the same byte
for every weight), so one output column's bytes are contiguous for the
kernel.  Activations are quantized per row to int8 with
``scale = max(amax / 127, 1e-8)``.

:class:`W4Linear` holds one packed layer; :func:`quantize_module_int4` swaps
the large ``nn.Linear`` layers of a model for it in place.  Its forward is
:func:`w4a8_linear`:

- ``K/2 % 128`` or ``N % 128``: the dense fallback (dequantize in fp32, no
  activation quantization), the JAX package's semantics for such layers;
- otherwise K3, :func:`w4a8_matmul` (``csrc/w4a8_matmul.cu``), which
  replaces ``_w4a8_kernel`` / ``_w4a8_kernel_i32``, at every M: a GEMV on
  the CUDA cores for M <= 16, and above that a TMA + ``wgmma`` int8 GEMM
  whose weights are unpacked in registers.  The JAX package sends
  M >= 8192 to an unpack and an XLA int8 dot instead; ``chip_smoke.py``
  times K3 beside an unpack and ``torch._int_mm`` there; the int32
  accumulators are the same.

:func:`w4a8_linear` is differentiable in x, straight through the
activation quantizer, with a zero weight cotangent (the JAX package's
``custom_vjp``): its backward is K9 :func:`w4_bwd_dx` (``csrc/w4_bwd_dx.cu``,
a TMA + ``wgmma`` bf16 GEMM whose weight planes a producer warpgroup
unpacks into shared memory), which replaces ``_w4_bwd_dx_kernel``, or the
dense fp32 fallback where ``K/2 % 128`` or ``N % 128``.  That is what lets
LoRA train over a frozen packed-int4 DiT.

The K3 and K9 wrappers take their plain PyTorch versions
(:func:`w4a8_matmul_reference`, :func:`w4_bwd_dx_reference`) for a tensor on
the CPU.  For a CUDA tensor they launch the kernel or raise; ``LAUNCHES``
counts the launches, and ``REGIME_LAUNCHES`` K3's by regime.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from physicedit_torch.kernels import _build

# DiT leaves that stay in the working dtype in the production W4A8 spec: the
# embed and head layers run once per forward, but quantizing them dominates
# the divergence of the whole denoise (the JAX package's DIT_OUTER_KEYS).
DIT_OUTER_KEYS = ("img_in", "txt_in", "time_embed", "norm_out", "proj_out",
                  "txt_norm")

LAUNCHES = {"w4a8_matmul": 0, "w4_bwd_dx": 0}
# K3's launches by regime: the GEMV (M <= 16) and the tiled GEMM
REGIME_LAUNCHES = {"gemv": 0, "tiled": 0}
GEMV_MAX_ROWS = 16


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, REGIME_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# Packing and quantization
# ---------------------------------------------------------------------------

def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as the JAX package and the kernels divide.
    PyTorch's CUDA kernels turn a division by a Python number into a product
    with its reciprocal, which can be one ulp off; a 0-dim divisor on x's
    device keeps the true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantized_row_chunks(w: torch.Tensor, qmax: int):
    """Quantize an ``[N, K]`` weight per output row, symmetric to
    ``[-qmax, qmax]`` with ``scale = max(amax / qmax, 1e-8)``; yields
    ``(r0, codes int8 [rows, K], scale fp32 [rows])`` a chunk of rows at a
    time, so a large layer needs only a few hundred MB of fp32 scratch."""
    k = w.shape[1]
    step = max(1, (1 << 26) // k)
    for r0 in range(0, w.shape[0], step):
        wf = w[r0:r0 + step].float()
        scale = true_div(wf.abs().amax(1, keepdim=True), float(qmax)).clamp_min(1e-8)
        yield r0, (wf / scale).round().clamp(-qmax, qmax).to(torch.int8), scale[:, 0]


@torch.no_grad()
def quantize_weight_int4(w: torch.Tensor):
    """``[N, K]`` weight (torch's ``[out, in]``) -> ``(w4 int8 [N, K/2],
    w_scale fp32 [N])``, the bytes of ``quantize_weight_int4`` in the JAX
    package."""
    n, k = w.shape
    if k % 2:
        raise ValueError(f"contraction dim {k} must be even for nibble packing")
    w4 = torch.empty((n, k // 2), dtype=torch.int8, device=w.device)
    w_scale = torch.empty((n,), dtype=torch.float32, device=w.device)
    for r0, q, scale in quantized_row_chunks(w, 7):
        w4[r0:r0 + len(q)] = (q[:, k // 2:] << 4) | ((q[:, :k // 2] + 8) & 0xF)
        w_scale[r0:r0 + len(q)] = scale
    return w4, w_scale


def quantize_rows(x: torch.Tensor):
    """``[..., K]`` float -> (int8 values, fp32 per-row scales ``[..., 1]``)."""
    xf = x.float()
    scale = true_div(xf.abs().amax(-1, keepdim=True), 127.0).clamp_min(1e-8)
    return (xf / scale).round().clamp(-127, 127).to(torch.int8), scale


def _unpack_w4_int8(w4: torch.Tensor) -> torch.Tensor:
    """``[N, K/2]`` packed -> ``[N, K]`` int8 (low plane first)."""
    return torch.cat([(w4 & 15) - 8, w4 >> 4], dim=1)


def _dequant_w4(w4: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``[N, K/2]`` packed -> ``[N, K]`` fp32 weights."""
    return _unpack_w4_int8(w4).float() * w_scale.float()[:, None]


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _exact_mm(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The int32 product ``xq . w8^T`` of int8 ``[M, K]`` and ``[N, K]``,
    exactly: int64 on the CPU, float64 on the card (|acc| < K * 128 * 128 is
    far inside 2^53)."""
    if xq.is_cuda:
        return (xq.double() @ w8.double().T).to(torch.int32)
    return (xq.long() @ w8.long().T).to(torch.int32)


def _exact_acc(xq: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """The int32 accumulator ``xq . unpack(w4)^T``, exactly (:func:`_exact_mm`)."""
    return _exact_mm(xq, _unpack_w4_int8(w4))


def _epilogue(acc, xs, w_scale, bias, out_dtype):
    """``acc * x_scale * w_scale + b`` in fp32, in the JAX kernel's order."""
    out = acc.float() * xs * w_scale.float()[None, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def w4a8_matmul_reference(xq, w4, xs, w_scale, bias=None, out_dtype=torch.bfloat16,
                          return_acc: bool = False):
    """Plain version of K3: the exact int32 accumulator, then the epilogue."""
    acc = _exact_acc(xq, w4)
    out = _epilogue(acc, xs.reshape(-1, 1), w_scale, bias, out_dtype)
    return (out, acc) if return_acc else out


def w4a8_matmul(xq, w4, xs, w_scale, bias=None, out_dtype=torch.bfloat16,
                return_acc: bool = False):
    """K3: ``(xq . unpack(w4)^T) * xs * w_scale + bias`` -> ``[M, N]``.

    xq int8 ``[M, K]``; w4 int8 ``[N, K/2]``; xs fp32 ``[M, 1]``; w_scale
    fp32 ``[N]``; bias ``[N]`` or None.  On the card: bf16 out and bias,
    ``K/2 % 128 == 0`` and ``N % 128 == 0`` (the JAX kernel's contract).
    ``return_acc`` also returns the int32 accumulators (for checks).
    """
    if xq.device.type == "cpu":
        return w4a8_matmul_reference(xq, w4, xs, w_scale, bias, out_dtype, return_acc)
    m, k = xq.shape
    n, k2 = w4.shape
    if xq.dtype != torch.int8 or w4.dtype != torch.int8 or k != 2 * k2:
        raise ValueError(f"w4a8_matmul: x {xq.dtype} {tuple(xq.shape)} and w4 "
                         f"{w4.dtype} {tuple(w4.shape)} do not fit int8 [M, K] x [N, K/2]")
    if k2 % 128 or n % 128:
        raise ValueError(f"w4a8_matmul: K/2 = {k2} and N = {n} must be multiples of 128")
    if out_dtype != torch.bfloat16 or (bias is not None and bias.dtype != torch.bfloat16):
        raise ValueError("w4a8_matmul: the kernel writes bf16 and takes a bf16 bias")
    xs = xs.reshape(m)
    for name, t, dt in (("xq", xq, torch.int8), ("w4", w4, torch.int8),
                        ("xs", xs, torch.float32), ("w_scale", w_scale, torch.float32),
                        ("bias", bias, torch.bfloat16)):
        if t is None:
            continue
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w4a8_matmul: {name} must be a contiguous, 16-byte aligned "
                             f"CUDA {dt} tensor")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    acc = torch.empty((m, n), dtype=torch.int32, device=xq.device) if return_acc else None
    ptr = _build.ptr
    _build.launch("w4a8_matmul", "w4a8_matmul_bf16", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3,
                  ptr(xq), ptr(w4), ptr(xs), ptr(w_scale), ptr(bias), ptr(out), ptr(acc),
                  m, n, k)
    LAUNCHES["w4a8_matmul"] += 1
    REGIME_LAUNCHES["gemv" if m <= GEMV_MAX_ROWS else "tiled"] += 1
    return (out, acc) if return_acc else out


# ---------------------------------------------------------------------------
# K9: the input gradient
# ---------------------------------------------------------------------------

def w4_bwd_dx_reference(g, w4, w_scale):
    """Plain version of K9: ``dx = bf16(g * w_scale) . unpack(w4)`` with fp32
    sums, in g's dtype (``_w4_bwd_dx`` of the JAX package: g2 is rounded to
    bf16 after the multiply whatever g's dtype)."""
    g2 = (g.float() * w_scale.float()[None, :]).to(torch.bfloat16).float()
    return (g2 @ _unpack_w4_int8(w4).float()).to(g.dtype)


def w4_bwd_dx(g, w4, w_scale):
    """K9: ``dx [M, K] = bf16(g * w_scale) [M, N] . unpack(w4)`` for w4 int8
    ``[N, K/2]`` and w_scale fp32 ``[N]``.  On the card: g bf16, dx bf16,
    ``K/2 % 128 == 0`` and ``N % 128 == 0``."""
    if g.device.type == "cpu":
        return w4_bwd_dx_reference(g, w4, w_scale)
    m, n = g.shape
    n_w, k2 = w4.shape
    if g.dtype != torch.bfloat16 or w4.dtype != torch.int8 or n_w != n:
        raise ValueError(f"w4_bwd_dx: g {g.dtype} {tuple(g.shape)} and w4 {w4.dtype} "
                         f"{tuple(w4.shape)} do not fit bf16 [M, N] x int8 [N, K/2]")
    if k2 % 128 or n % 128:
        raise ValueError(f"w4_bwd_dx: K/2 = {k2} and N = {n} must be multiples of 128")
    for name, t, dt in (("g", g, torch.bfloat16), ("w4", w4, torch.int8),
                        ("w_scale", w_scale, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w4_bwd_dx: {name} must be a contiguous, 16-byte aligned "
                             f"CUDA {dt} tensor")
    if w_scale.shape != (n,):
        raise ValueError(f"w4_bwd_dx: w_scale {tuple(w_scale.shape)} is not [{n}]")
    dx = torch.empty((m, 2 * k2), dtype=torch.bfloat16, device=g.device)
    ptr = _build.ptr
    _build.launch("w4_bwd_dx", "w4_bwd_dx_bf16", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
                  ptr(g), ptr(w4), ptr(w_scale), ptr(dx), m, n, 2 * k2)
    LAUNCHES["w4_bwd_dx"] += 1
    return dx


# ---------------------------------------------------------------------------
# The linear layer and its dispatch
# ---------------------------------------------------------------------------

class W4Linear(nn.Module):
    """A linear layer with packed-int4 weights: the JAX leaf
    ``{"w4", "w_scale", "b"}``.  ``w4`` (int8 ``[out, in/2]``) and
    ``w_scale`` (fp32 ``[out]``) are buffers; the optional bias keeps the
    working dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, device="meta"):
        super().__init__()
        if in_features % 2:
            raise ValueError(f"in_features {in_features} must be even for nibble packing")
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w4", torch.empty((out_features, in_features // 2),
                                               dtype=torch.int8, device=device))
        self.register_buffer("w_scale", torch.empty((out_features,), dtype=torch.float32,
                                                    device=device))
        self.bias = (nn.Parameter(torch.empty((out_features,), dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "W4Linear":
        """Quantize ``lin``; the result shares its bias parameter."""
        q = cls(lin.in_features, lin.out_features, bias=False, device="meta")
        q.w4, q.w_scale = quantize_weight_int4(lin.weight)
        q.bias = lin.bias
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w4a8_linear(self, x)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def _kernel_sized(lin: W4Linear) -> bool:
    return (lin.in_features // 2) % 128 == 0 and lin.out_features % 128 == 0


class _W4A8Linear(torch.autograd.Function):
    """``w4a8_linear`` differentiable in x: dx is K9 on kernel-sized layers,
    else the dense ``g . dequant(w4)`` in fp32; the weights take none."""

    @staticmethod
    def forward(ctx, x, lin):
        ctx.lin = lin
        return _w4a8_linear_impl(lin, x)

    @staticmethod
    def backward(ctx, g):
        lin = ctx.lin
        *lead, n = g.shape
        g2 = g.reshape(-1, n)
        if _kernel_sized(lin):
            dx = w4_bwd_dx(g2.contiguous(), lin.w4, lin.w_scale)
        else:
            dx = g2.float() @ _dequant_w4(lin.w4, lin.w_scale)
        return dx.reshape(*lead, lin.in_features).to(g.dtype), None


def w4a8_linear(lin: W4Linear, x: torch.Tensor) -> torch.Tensor:
    """``y = dequant(int8(x) . unpack(w4)) + b`` in x's dtype, over any
    leading dims (``w4a8_linear`` of the JAX package); differentiable in x
    when x requires grad."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _W4A8Linear.apply(x, lin)
    return _w4a8_linear_impl(lin, x)


def _w4a8_linear_impl(lin: W4Linear, x: torch.Tensor) -> torch.Tensor:
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if not _kernel_sized(lin):
        # below the kernel's tile: the JAX package's dense fp32 fallback
        out = x2.float() @ _dequant_w4(lin.w4, lin.w_scale).T
        if lin.bias is not None:
            out = out + lin.bias.float()
        return out.reshape(*lead, lin.out_features).to(x.dtype)
    xq, xs = quantize_rows(x2)
    return _w4a8_from_q(lin, xq, xs, lead, x.dtype)


def w4a8_linear_q(lin: W4Linear, xq: torch.Tensor, xs: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    """W4A8 linear on activations already quantized (by
    ``kernels/fused_quant.py``): xq int8 ``[..., K]``, xs fp32 ``[..., 1]``."""
    *lead, k = xq.shape
    if k != lin.in_features or not _kernel_sized(lin):
        raise ValueError(f"w4a8_linear_q: x {tuple(xq.shape)} does not fit a kernel-sized "
                         f"[{lin.in_features} -> {lin.out_features}] layer")
    return _w4a8_from_q(lin, xq.reshape(-1, k), xs.reshape(-1, 1), lead, out_dtype)


def _w4a8_from_q(lin: W4Linear, xq, xs, lead, out_dtype) -> torch.Tensor:
    out = w4a8_matmul(xq.contiguous(), lin.w4, xs.contiguous(), lin.w_scale, lin.bias,
                      out_dtype)
    return out.reshape(*lead, lin.out_features)


@torch.no_grad()
def swap_linears_(module: nn.Module, make, min_size: int, skip_top: tuple = ()) -> nn.Module:
    """Replace every large ``nn.Linear`` of ``module`` by ``make(linear)``,
    in place, one layer at a time (the JAX package's ``quantize_tree`` /
    ``quantize_tree_int4`` walk).  A layer is large when its weight, counted
    over the layers of every enclosing ``nn.ModuleList`` (the JAX package's
    stacked ``[L, ...]`` leaves), has at least ``min_size`` elements.
    Children of ``module`` named in ``skip_top`` stay as they are."""
    _swap_children(module, make, min_size, set(skip_top), 1)
    return module


def _swap_children(module: nn.Module, make, min_size: int, skip: set, stacked: int) -> None:
    for name, child in list(module.named_children()):
        if name in skip:
            continue
        if isinstance(child, nn.Linear):
            if child.weight.numel() * stacked >= min_size:
                setattr(module, name, make(child))
        elif isinstance(child, nn.ModuleList):
            _swap_children(child, make, min_size, set(), stacked * len(child))
        else:
            _swap_children(child, make, min_size, set(), stacked)


def quantize_module_int4(module: nn.Module, min_size: int = 1 << 16,
                         skip_top: tuple = ()) -> nn.Module:
    """Swap the large ``nn.Linear`` layers of ``module`` for
    :class:`W4Linear` in place (``quantize_tree_int4`` of the JAX package;
    :func:`swap_linears_`)."""
    return swap_linears_(module, W4Linear.from_linear, min_size, skip_top)
