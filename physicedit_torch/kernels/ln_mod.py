"""The DiT block's bf16 modulated LayerNorm, ``LN(x) * (1 + scale) +
shift``, and the gated residual in front of it: :func:`ln_mod` and
:func:`residual_ln_mod` (``csrc/ln_mod.cu``, ``ln_mod_kernel``).

It replaces no TPU kernel: the JAX package leaves the modulated LayerNorm
and the gated residuals to XLA, which fuses them.  The port ran them as
eager ATen ops, about 11 launches a modulated LayerNorm over fp32 copies of
x and two a gated residual; one launch now reads x (and, for the residual,
o) once and writes the bf16 result once.

The kernel keeps the eager ops' roundings (``ops/norms.layer_norm``, its
result cast to x's dtype before the affine, then the affine's bf16 ops);
only the order of the statistics' sums differs.  Those eager ops are the
plain versions, :func:`ln_mod_reference` and
:func:`residual_ln_mod_reference`.  The kernel has no backward, so it serves
calls made with grad off: a wrapper runs its plain version, which autograd
differentiates, with grad on and on CPU tensors.  Otherwise it launches the
kernel or raises (not bf16, a width that is not a multiple of 256 up to
3072, misaligned or strided operands); it never falls back.  ``LAUNCHES``
counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from physicedit_torch.kernels import _build
from physicedit_torch.ops.norms import layer_norm

CHUNK = 256       # the width a warp loads at once
MAX_WIDTH = 3072  # the widest row a warp holds in registers

LAUNCHES = {"ln_mod": 0, "residual_ln_mod": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def ln_mod_reference(x, shift, scale, eps: float = 1e-6):
    """``LN(x) * (1 + scale) + shift`` in eager ops, which autograd
    differentiates: x [B, S, D], shift and scale [B, D]."""
    return layer_norm(x, eps=eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]


def residual_ln_mod_reference(x, o, gate, shift, scale, eps: float = 1e-6):
    """``x' = x + gate * o`` and ``ln_mod_reference(x')`` in eager ops;
    returns (x', y)."""
    x = x + gate[:, None, :] * o
    return x, ln_mod_reference(x, shift, scale, eps)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _check(fn: str, x, rows: dict) -> tuple[int, int, int]:
    """B, S, D of x after the checks the kernel's loads need; ``rows`` the
    [B, D] operands by name."""
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be [B, S, D] (got {tuple(x.shape)})")
    b, s, d = x.shape
    if d % CHUNK or not 0 < d <= MAX_WIDTH:
        raise ValueError(f"{fn}: width {d}, the kernel takes a multiple of {CHUNK} up to "
                         f"{MAX_WIDTH}")
    for name, t in (("x", x), *rows.items()):
        if not t.is_cuda or t.device != x.device or t.dtype != torch.bfloat16 or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be a 16-byte aligned torch.bfloat16 tensor on "
                             f"x's CUDA device (got {t.dtype} on {t.device})")
    if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8:
        raise ValueError(f"{fn}: x's rows must be contiguous with strides a multiple of 8 "
                         f"(got {x.stride()})")
    for name, t in rows.items():
        if t.shape != (b, d) or t.stride(1) != 1 or t.stride(0) % 8:
            raise ValueError(f"{fn}: {name} must be [{b}, {d}] with contiguous rows and a "
                             f"batch stride a multiple of 8 (got {tuple(t.shape)}, strides "
                             f"{t.stride()})")
    return b, s, d


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
             + [ctypes.c_void_p, ctypes.c_int64] * 2 + [ctypes.c_void_p]
             + [ctypes.c_int] * 3 + [ctypes.c_float])
_RESIDUAL_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
                      + [ctypes.c_void_p, ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 3 + [ctypes.c_float])


def ln_mod(x, shift, scale, eps: float = 1e-6):
    """``LN(x) * (1 + scale) + shift`` of x [B, S, D] (its rows may be
    strided) with shift and scale [B, D]; returns a contiguous [B, S, D].
    The kernel has no backward, so it serves calls made with grad off; with
    grad on, or on CPU tensors, the plain version."""
    if x.device.type == "cpu" or torch.is_grad_enabled():
        return ln_mod_reference(x, shift, scale, eps)
    b, s, d = _check("ln_mod", x, {"shift": shift, "scale": scale})
    y = x.new_empty((b, s, d))
    p = _build.ptr
    _build.launch("ln_mod", "ln_mod_bf16", _ARGTYPES, p(x), x.stride(0), x.stride(1), p(shift),
                  shift.stride(0), p(scale), scale.stride(0), p(y), b, s, d, float(eps))
    LAUNCHES["ln_mod"] += 1
    return y


def residual_ln_mod(x, o, gate, shift, scale, eps: float = 1e-6):
    """The gated residual ``x' = x + gate * o`` and the modulated LayerNorm
    of x' (read as rounded to x's dtype): x [B, S, D] (its rows may be
    strided), o [B, S, D] contiguous, gate, shift and scale [B, D].
    Returns (x', y), both contiguous [B, S, D].  The kernel has no
    backward, so it serves calls made with grad off; with grad on, or on
    CPU tensors, the plain version."""
    if x.device.type == "cpu" or torch.is_grad_enabled():
        return residual_ln_mod_reference(x, o, gate, shift, scale, eps)
    b, s, d = _check("residual_ln_mod", x, {"gate": gate, "shift": shift, "scale": scale})
    if o.shape != x.shape or not o.is_contiguous():
        raise ValueError(f"residual_ln_mod: o must be a contiguous {tuple(x.shape)} (got "
                         f"{tuple(o.shape)}, strides {o.stride()})")
    _check("residual_ln_mod", o, {})
    x_out, y = x.new_empty((b, s, d)), x.new_empty((b, s, d))
    p = _build.ptr
    _build.launch("ln_mod", "residual_ln_mod_bf16", _RESIDUAL_ARGTYPES, p(x), x.stride(0),
                  x.stride(1), p(o), p(gate), gate.stride(0), p(shift), shift.stride(0),
                  p(scale), scale.stride(0), p(x_out), p(y), b, s, d, float(eps))
    LAUNCHES["residual_ln_mod"] += 1
    return x_out, y
