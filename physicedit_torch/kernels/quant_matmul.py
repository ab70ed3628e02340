"""The W4A8 lane: packed-int4 weights, int8 activations
(``physicedit_tpu/kernels/quant_matmul.py``), and kernel K3.

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
  replaces ``_w4a8_kernel`` / ``_w4a8_kernel_i32``, at every M.  The JAX
  package sends M >= 8192 to an unpack and an XLA int8 dot instead.  On the
  H100, K3 beats an unpack to int8 plus ``torch._int_mm`` and its fp32
  epilogue over a whole DiT step, though not at every shape
  (``chip_smoke.py`` times both); the int32 accumulators are the same.

The K3 wrapper takes its plain PyTorch version (:func:`w4a8_matmul_reference`)
for a tensor on the CPU.  For a CUDA tensor it launches the kernel or raises;
``LAUNCHES`` counts the launches.
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

LAUNCHES = {"w4a8_matmul": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Packing and quantization
# ---------------------------------------------------------------------------

def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as the JAX package and the kernels divide.
    PyTorch's CUDA kernels turn a division by a Python number into a product
    with its reciprocal, which can be one ulp off; a 0-dim divisor on x's
    device keeps the true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


@torch.no_grad()
def quantize_weight_int4(w: torch.Tensor):
    """``[N, K]`` weight (torch's ``[out, in]``) -> ``(w4 int8 [N, K/2],
    w_scale fp32 [N])``, the bytes of ``quantize_weight_int4`` in the JAX
    package.  Rows are quantized in chunks, so a large layer needs only a
    few hundred MB of fp32 scratch."""
    n, k = w.shape
    if k % 2:
        raise ValueError(f"contraction dim {k} must be even for nibble packing")
    w4 = torch.empty((n, k // 2), dtype=torch.int8, device=w.device)
    w_scale = torch.empty((n,), dtype=torch.float32, device=w.device)
    step = max(1, (1 << 26) // k)
    for r0 in range(0, n, step):
        wf = w[r0:r0 + step].float()
        scale = true_div(wf.abs().amax(1, keepdim=True), 7.0).clamp_min(1e-8)
        q = (wf / scale).round().clamp(-7, 7).to(torch.int8)
        w4[r0:r0 + step] = (q[:, k // 2:] << 4) | ((q[:, :k // 2] + 8) & 0xF)
        w_scale[r0:r0 + step] = scale[:, 0]
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

def _exact_acc(xq: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """The int32 accumulator ``xq . unpack(w4)^T``, exactly: int64 on the CPU,
    float64 on the card (|acc| < K * 127 * 8 is far inside 2^53)."""
    w8 = _unpack_w4_int8(w4)
    if xq.is_cuda:
        return (xq.double() @ w8.double().T).to(torch.int32)
    return (xq.long() @ w8.long().T).to(torch.int32)


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
    return (out, acc) if return_acc else out


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


def w4a8_linear(lin: W4Linear, x: torch.Tensor) -> torch.Tensor:
    """``y = dequant(int8(x) . unpack(w4)) + b`` in x's dtype, over any
    leading dims (``_w4a8_linear_impl`` of the JAX package)."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if (lin.in_features // 2) % 128 or lin.out_features % 128:
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
    if k != lin.in_features or (k // 2) % 128 or lin.out_features % 128:
        raise ValueError(f"w4a8_linear_q: x {tuple(xq.shape)} does not fit a kernel-sized "
                         f"[{lin.in_features} -> {lin.out_features}] layer")
    return _w4a8_from_q(lin, xq.reshape(-1, k), xs.reshape(-1, 1), lead, out_dtype)


def _w4a8_from_q(lin: W4Linear, xq, xs, lead, out_dtype) -> torch.Tensor:
    out = w4a8_matmul(xq.contiguous(), lin.w4, xs.contiguous(), lin.w_scale, lin.bias,
                      out_dtype)
    return out.reshape(*lead, lin.out_features)


@torch.no_grad()
def quantize_module_int4(module: nn.Module, min_size: int = 1 << 16,
                         skip_top: tuple = ()) -> nn.Module:
    """Swap every large ``nn.Linear`` of ``module`` for a :class:`W4Linear`,
    in place, one layer at a time (``quantize_tree_int4`` of the JAX
    package).  A layer is large when its weight, counted over the layers of
    every enclosing ``nn.ModuleList`` (the JAX package's stacked ``[L, ...]``
    leaves), has at least ``min_size`` elements.  Children of ``module``
    named in ``skip_top`` stay as they are."""
    _quantize_children(module, min_size, set(skip_top), 1)
    return module


def _quantize_children(module: nn.Module, min_size: int, skip: set, stacked: int) -> None:
    for name, child in list(module.named_children()):
        if name in skip:
            continue
        if isinstance(child, nn.Linear):
            if child.weight.numel() * stacked >= min_size:
                setattr(module, name, W4Linear.from_linear(child))
        elif isinstance(child, nn.ModuleList):
            _quantize_children(child, min_size, set(), stacked * len(child))
        else:
            _quantize_children(child, min_size, set(), stacked)
