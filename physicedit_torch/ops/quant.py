"""The W8A8 lane: int8 weights, int8 activations
(``physicedit_tpu/ops/quant.py``, the JAX package's ``quantize="int8"``).

Weights are quantized offline per output channel, symmetric, with
``scale = max(amax / 127, 1e-8)``; activations per row at run time with the
same rule.  The int8 product accumulates in int32 and is dequantized in
fp32: ``acc * x_scale * w_scale``, then ``+ b`` in fp32, then the cast to
x's dtype, in the JAX package's order.

The JAX package computes that product in XLA (``lax.dot_general`` with an
int32 result), not in a Pallas kernel, so the port takes PyTorch's own int8
GEMM, ``torch._int_mm``, on the CPU and on the card alike.  On the card it
needs more than 16 rows and a contraction and output width that are
multiples of 8: fewer rows are padded with zero rows (the integer product
of the live rows is unchanged), and a layer whose widths are not multiples
of 8 raises.  Nothing falls back to a float product.

:class:`Int8Linear` holds one layer as ``w_q int8 [N, K]`` (torch's
``[out, in]``; the JAX package keeps ``[K, N]``) and ``w_scale fp32 [N]``;
:func:`quantize_module_int8` swaps a model's large ``nn.Linear`` layers for
it in place.  ``CALLS["int_mm"]`` counts the ``torch._int_mm`` calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.kernels.quant_matmul import (quantize_rows, quantized_row_chunks,
                                                   swap_linears_)

__all__ = ["CALLS", "Int8Linear", "int8_linear", "int_mm", "quantize_module_int8",
           "quantize_rows", "quantize_weight", "reset_call_counts"]

CALLS = {"int_mm": 0}
INT_MM_MIN_ROWS = 17    # torch._int_mm on CUDA takes more than 16 rows


def reset_call_counts() -> None:
    CALLS["int_mm"] = 0


@torch.no_grad()
def quantize_weight(w: torch.Tensor):
    """``[N, K]`` float weight -> ``(w_q int8 [N, K], w_scale fp32 [N])``:
    per-output-channel symmetric int8, the JAX package's ``quantize_weight``
    of the ``[K, N]`` transpose."""
    n, k = w.shape
    w_q = torch.empty((n, k), dtype=torch.int8, device=w.device)
    w_scale = torch.empty((n,), dtype=torch.float32, device=w.device)
    for r0, q, scale in quantized_row_chunks(w, 127):
        w_q[r0:r0 + len(q)] = q
        w_scale[r0:r0 + len(q)] = scale
    return w_q, w_scale


def int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 product ``xq . w_q^T`` of int8 ``[M, K]`` and ``[N, K]``
    through ``torch._int_mm`` (its second operand column-major: ``w_q.t()``)."""
    m, k = xq.shape
    n = w_q.shape[0]
    rows = m
    if xq.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8_linear: torch._int_mm on CUDA needs K and N that are "
                             f"multiples of 8, this layer is [{k} -> {n}]")
        if m < INT_MM_MIN_ROWS:
            xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(xq.contiguous(), w_q.t())
    CALLS["int_mm"] += 1
    return acc[:rows]


def int8_linear(lin: "Int8Linear", x: torch.Tensor) -> torch.Tensor:
    """``y = dequant(int8(x) . w_q) (+ b)`` over any leading dims, in x's
    dtype (the JAX package's ``int8_linear``)."""
    *lead, k = x.shape
    xq, xs = quantize_rows(x.reshape(-1, k))
    acc = int_mm(xq, lin.w_q)
    out = acc.float() * xs * lin.w_scale
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.reshape(*lead, lin.out_features).to(x.dtype)


class Int8Linear(nn.Module):
    """One W8A8 layer: ``w_q int8 [N, K]``, ``w_scale fp32 [N]`` and an
    optional bias in the working dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None,
                 device="meta"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_q", torch.empty((out_features, in_features), dtype=torch.int8,
                                                device=device))
        self.register_buffer("w_scale", torch.empty((out_features,), dtype=torch.float32,
                                                    device=device))
        self.bias = (nn.Parameter(torch.empty((out_features,), dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        """Quantize ``lin``; the result shares its bias parameter."""
        q = cls(lin.in_features, lin.out_features, bias=False, device="meta")
        q.w_q, q.w_scale = quantize_weight(lin.weight)
        q.bias = lin.bias
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(self, x)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def quantize_module_int8(module: nn.Module, min_size: int = 1 << 16) -> nn.Module:
    """Swap the large ``nn.Linear`` layers of ``module`` for
    :class:`Int8Linear` in place (the JAX package's ``quantize_tree``;
    :func:`swap_linears_`).  A stacked leaf's scales are per layer and
    output channel, one :class:`Int8Linear` a layer; each layer's float
    weight is freed as soon as its int8 copy exists."""
    return swap_linears_(module, Int8Linear.from_linear, min_size)
