"""The fused activation-quantize passes of the W4A8 DiT block
(``physicedit_tpu/kernels/fused_quant.py``): kernels K4, K5 and K6.

Each produces the int8 rows and fp32 row scales that ``w4a8_linear_q``
consumes, in one pass over its bf16 input:

- K4 :func:`ln_mod_quant`: ``LN(x) * (1 + scale) + shift``, replacing
  ``_ln_mod_quant_kernel``;
- K5 :func:`gelu_quant`: ``x * sigmoid(1.702 x)``, replacing
  ``_gelu_quant_kernel``;
- K6 :func:`transpose_quant`: ``[B, N, S, D] -> [B, S, N * D]``, replacing
  ``_transpose_quant_kernel``.

All three live in ``csrc/fused_quant.cu``.  Each public function returns
None when the JAX package's returns None (the last dim not a multiple of
128, or an S with no row block among 512, ..., 8 under its VMEM budget), so
the DiT takes the fused path exactly where the JAX package does.  The
wrappers take their plain PyTorch versions (``*_reference``) for tensors on
the CPU; for CUDA tensors they launch the kernel or raise.  ``LAUNCHES``
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from physicedit_torch.kernels import _build
from physicedit_torch.kernels.quant_matmul import quantize_rows, true_div

LAUNCHES = {"ln_mod_quant": 0, "gelu_quant": 0, "transpose_quant": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pick_bm(s: int, k: int) -> int | None:
    """The JAX package's row block: the largest of 512, ..., 8 that divides
    S with an fp32 tile of at most ~3 MB; None when there is none."""
    budget = max(786432 // k, 8)
    for bm in (512, 256, 128, 64, 32, 16, 8):
        if bm <= budget and s % bm == 0:
            return bm
    return None


# ---------------------------------------------------------------------------
# Plain versions, with the kernels' numerics
# ---------------------------------------------------------------------------

def ln_mod_quant_reference(x, shift, scale, eps: float = 1e-6):
    """LN statistics in fp32, summed in fp64 (as the kernel sums them) and
    ``1 / sqrt``; the LN cast to x's dtype before the affine, whose steps
    each round to x's dtype; then the row quantization."""
    xf = x.float()
    k = x.shape[-1]
    mean = true_div(xf.double().sum(-1, keepdim=True), k).float()
    xc = xf - mean
    var = true_div((xc * xc).double().sum(-1, keepdim=True), k).float()
    ln = (xc * torch.sqrt(var + eps).reciprocal()).to(x.dtype)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    y = ln * (one + scale.to(x.dtype)[:, None, :]) + shift.to(x.dtype)[:, None, :]
    return quantize_rows(y.float())


def gelu_quant_reference(x):
    """``x * sigmoid(1.702 x)`` in fp32, then the row quantization."""
    xf = x.float()
    return quantize_rows(xf * (1.0 + torch.exp(-(1.702 * xf))).reciprocal())


def transpose_quant_reference(x):
    """``[B, N, S, D] -> [B, S, N * D]``, then the row quantization."""
    b, n, s, d = x.shape
    return quantize_rows(x.transpose(1, 2).reshape(b, s, n * d).float())


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(name: str, tensors: dict) -> None:
    for tname, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be a contiguous, 16-byte aligned CUDA "
                             f"bf16 tensor (got {t.dtype} on {t.device})")


def _launch(name: str, argtypes: list, *args) -> None:
    _build.launch("fused_quant", f"{name}_bf16", argtypes, *args)
    LAUNCHES[name] += 1


def row_pipeline_launch(name: str, rows: int, k: int) -> dict:
    """The launch K4 (``ln_mod_quant``) or K5 (``gelu_quant``) takes over
    ``rows`` rows of width ``k`` on the current card: threads per block, ring
    slots per row group, dynamic shared memory, blocks per SM, grid, and the
    kernel's template arguments: warps per row and ``nv`` (16-element chunks
    per thread)."""
    fn = _build.load("fused_quant").row_pipeline_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    rc = fn(("ln_mod_quant", "gelu_quant").index(name), rows, k, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"row_pipeline_launch: CUDA error {rc}")
    return dict(zip(("threads", "stages", "dynamic_smem_bytes", "blocks_per_sm", "grid",
                     "warps_per_row", "nv"), out))


def _outputs(x: torch.Tensor, b: int, s: int, k: int):
    return (torch.empty((b, s, k), dtype=torch.int8, device=x.device),
            torch.empty((b, s, 1), dtype=torch.float32, device=x.device))


def _ln_mod_quant(x, shift, scale, eps: float):
    if x.device.type == "cpu":
        return ln_mod_quant_reference(x, shift, scale, eps)
    b, s, k = x.shape
    shift, scale = shift.contiguous(), scale.contiguous()
    _check("ln_mod_quant", {"x": x, "shift": shift, "scale": scale})
    if shift.shape != (b, k) or scale.shape != (b, k):
        raise ValueError(f"ln_mod_quant: shift/scale must be [{b}, {k}]")
    q, qs = _outputs(x, b, s, k)
    ptr = _build.ptr
    _launch("ln_mod_quant", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float],
            ptr(x), ptr(shift), ptr(scale), ptr(q), ptr(qs), b, s, k, float(eps))
    return q, qs


def _gelu_quant(x):
    if x.device.type == "cpu":
        return gelu_quant_reference(x)
    b, s, k = x.shape
    _check("gelu_quant", {"x": x})
    q, qs = _outputs(x, b, s, k)
    ptr = _build.ptr
    _launch("gelu_quant", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2,
            ptr(x), ptr(q), ptr(qs), b * s, k)
    return q, qs


def _transpose_quant(x):
    if x.device.type == "cpu":
        return transpose_quant_reference(x)
    b, n, s, d = x.shape
    _check("transpose_quant", {"x": x})
    q, qs = _outputs(x, b, s, n * d)
    ptr = _build.ptr
    _launch("transpose_quant", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
            ptr(x), ptr(q), ptr(qs), b, n, s, d)
    return q, qs


# ---------------------------------------------------------------------------
# Public entry points (the JAX package's, with its None predicates)
# ---------------------------------------------------------------------------

def ln_mod_quant(x, shift, scale, eps: float = 1e-6):
    """Fused LN + modulate + row quantize.  x ``[B, S, K]``; shift/scale
    ``[B, K]``.  Returns (int8 ``[B, S, K]``, fp32 ``[B, S, 1]``) or None
    when the shape does not tile."""
    if x.dim() != 3 or x.shape[-1] % 128 or _pick_bm(x.shape[1], x.shape[2]) is None:
        return None
    return _ln_mod_quant(x, shift.to(x.dtype), scale.to(x.dtype), eps)


def gelu_quant(x):
    """Fused approximate GELU + row quantize; the contract of ln_mod_quant."""
    if x.dim() != 3 or x.shape[-1] % 128 or _pick_bm(x.shape[1], x.shape[2]) is None:
        return None
    return _gelu_quant(x)


def transpose_quant(x):
    """Fused ``[B, N, S, D] -> int8 [B, S, N * D]`` + row scales (the
    attention output's transpose and the row quantize in one pass); None
    when the shape does not tile."""
    if x.dim() != 4 or (x.shape[1] * x.shape[3]) % 128 or x.shape[3] % 128:
        return None
    if _pick_bm(x.shape[2], x.shape[1] * x.shape[3]) is None:
        return None
    return _transpose_quant(x)
