"""The DiT block's q / k RMSNorm + RoPE, written with v straight into the
joint buffers the attention reads: :func:`qk_norm_rope`
(``csrc/qk_norm_rope.cu``, ``qk_norm_rope_kernel``).

It replaces no TPU kernel: the JAX package leaves ``rms_norm`` and
``apply_rope`` to XLA, which fuses them.  The port ran them as eager ATen
ops in fp32 and joined the two streams with three ``torch.cat``; one launch
now reads both streams' QKV projections ``[B, S, 3 N D]`` once and writes q,
k and v once as ``[B, N, S_t + S_i, D]``, the text stream's rows first.  In
the slim last block (``slim_base > 0``) q holds the first ``slim_base``
image rows only.

The kernel keeps the eager path's roundings (``ops/norms.rms_norm``, then
``ops/rope.apply_rope``); only the order of the 128 squares' sum differs.
Those eager ops are the plain version, :func:`qk_norm_rope_reference`.  The
kernel has no backward, so it serves calls made with grad off: the wrapper
runs the plain version, which autograd differentiates, with grad on and on
CPU tensors.  Otherwise it launches the kernel or raises (fp32, head_dim
other than 128, a table elsewhere, misaligned or strided operands); it never
falls back.  ``LAUNCHES`` counts the launches, one per block.

:func:`qk_norm_rope_joint` serves the FLUX DiT's single-stream blocks
(``models/flux.py``), whose one QKV projection ``[B, S_t + S_i, 3 N D]``
covers the joint sequence under one gain pair: its text rows and its image
rows go in as the two streams, views of the one tensor (at B > 1 their
batch stride is the joint length's), with no copy, through the same launch.
"""
from __future__ import annotations

import ctypes

import torch

from physicedit_torch.kernels import _build
from physicedit_torch.ops.norms import rms_norm
from physicedit_torch.ops.rope import apply_rope

HEAD_DIM = 128
PAIRS = HEAD_DIM // 2

LAUNCHES = {"qk_norm_rope": 0}


def reset_launch_counts() -> None:
    LAUNCHES["qk_norm_rope"] = 0


def _shape(img_qkv, txt_qkv, head_dim: int):
    b, s_i, width = img_qkv.shape
    n = width // (3 * head_dim)
    if (width != 3 * n * head_dim or txt_qkv.dim() != 3 or txt_qkv.shape[0] != b
            or txt_qkv.shape[2] != width):
        raise ValueError(f"qk_norm_rope: QKV outputs {tuple(img_qkv.shape)} / "
                         f"{tuple(txt_qkv.shape)} are not [B, S, 3 N {head_dim}] of one B and N")
    return b, n, txt_qkv.shape[1], s_i


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def qk_norm_rope_reference(img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos, txt_sin,
                           eps: float = 1e-6, slim_base: int = 0):
    """q, k, v of :func:`qk_norm_rope` in eager ops, which autograd
    differentiates: each stream's q / k ``apply_rope(rms_norm(.))``, then the
    text-first ``cat`` (q: the slim block's first ``slim_base`` image rows).
    gains: the (image q, image k, text q, text k) RMSNorm scales."""
    hd = gains[0].shape[-1]
    b, n, s_t, s_i = _shape(img_qkv, txt_qkv, hd)
    iq, ik, iv = img_qkv.view(b, s_i, 3, n, hd).permute(2, 0, 3, 1, 4)
    tq, tk, tv = txt_qkv.view(b, s_t, 3, n, hd).permute(2, 0, 3, 1, 4)
    iq = apply_rope(rms_norm(iq, gains[0], eps), img_cos, img_sin)
    ik = apply_rope(rms_norm(ik, gains[1], eps), img_cos, img_sin)
    tq = apply_rope(rms_norm(tq, gains[2], eps), txt_cos, txt_sin)
    tk = apply_rope(rms_norm(tk, gains[3], eps), txt_cos, txt_sin)
    q = iq[:, :, :slim_base].contiguous() if slim_base else torch.cat([tq, iq], dim=2)
    return q, torch.cat([tk, ik], dim=2), torch.cat([tv, iv], dim=2)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _stream_args(name: str, qkv, gq, gk, cos, sin, b: int, s: int, q0: int, q_rows: int):
    """One stream's arguments of ``qk_norm_rope_bf16``, after the checks
    the kernel's loads need."""
    for tname, t, dtype in (("QKV", qkv, torch.bfloat16), ("q gain", gq, torch.bfloat16),
                            ("k gain", gk, torch.bfloat16), ("cos", cos, torch.float32),
                            ("sin", sin, torch.float32)):
        if not t.is_cuda or t.device != qkv.device or t.dtype != dtype or t.data_ptr() % 16:
            raise ValueError(f"qk_norm_rope: {name} {tname} must be a 16-byte aligned {dtype} "
                             f"tensor on the QKV's CUDA device (got {t.dtype} on {t.device})")
    if qkv.stride(2) != 1 or qkv.stride(0) % 8 or qkv.stride(1) % 8:
        raise ValueError(f"qk_norm_rope: {name} QKV rows must be contiguous with strides a "
                         f"multiple of 8 (got {qkv.stride()})")
    if any(g.shape != (HEAD_DIM,) or g.stride() != (1,) for g in (gq, gk)):
        raise ValueError(f"qk_norm_rope: {name} gains must be contiguous [{HEAD_DIM}]")
    for tname, t in (("cos", cos), ("sin", sin)):
        if (t.shape[-2:] != (s, PAIRS) or t.dim() not in (2, 4) or t.stride(-1) != 1
                or t.stride(-2) != PAIRS
                or (t.dim() == 4 and (t.shape[1] != 1 or t.shape[0] not in (1, b)))):
            raise ValueError(f"qk_norm_rope: {name} {tname} must be [{s}, {PAIRS}] or "
                             f"[{b} or 1, 1, {s}, {PAIRS}] with contiguous rows "
                             f"(got {tuple(t.shape)}, strides {t.stride()})")
    if cos.shape != sin.shape or cos.stride() != sin.stride():
        raise ValueError(f"qk_norm_rope: {name} cos and sin differ in shape or strides")
    table_batch = cos.stride(0) if cos.dim() == 4 and cos.shape[0] > 1 else 0
    p = _build.ptr
    return (p(qkv), qkv.stride(0), qkv.stride(1), p(cos), p(sin), table_batch, p(gq), p(gk),
            s, q0, q_rows)


_STREAM_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
_ARGTYPES = (2 * _STREAM_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_float])


def _qk_norm_rope_cuda(img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos, txt_sin,
                       eps: float, slim_base: int):
    if gains[0].shape[-1] != HEAD_DIM:
        raise ValueError(f"qk_norm_rope: head_dim {gains[0].shape[-1]}, the kernel takes "
                         f"{HEAD_DIM}")
    b, n, s_t, s_i = _shape(img_qkv, txt_qkv, HEAD_DIM)
    # q's length, and per stream its first q row and how many of its tokens have one
    if slim_base:
        q_len, (tq0, tq_rows), (iq0, iq_rows) = slim_base, (0, 0), (0, slim_base)
    else:
        q_len, (tq0, tq_rows), (iq0, iq_rows) = s_t + s_i, (0, s_t), (s_t, s_i)
    txt = _stream_args("text", txt_qkv, gains[2], gains[3], txt_cos, txt_sin, b, s_t, tq0,
                       tq_rows)
    img = _stream_args("image", img_qkv, gains[0], gains[1], img_cos, img_sin, b, s_i, iq0,
                       iq_rows)
    if txt_qkv.device != img_qkv.device:
        raise ValueError("qk_norm_rope: the two streams are on different devices")
    q = img_qkv.new_empty((b, n, q_len, HEAD_DIM))
    k = img_qkv.new_empty((b, n, s_t + s_i, HEAD_DIM))
    v = torch.empty_like(k)
    p = _build.ptr
    _build.launch("qk_norm_rope", "qk_norm_rope_bf16", _ARGTYPES, *txt, *img, p(q), p(k), p(v),
                  b, n, q_len, float(eps))
    LAUNCHES["qk_norm_rope"] += 1
    return q, k, v


def qk_norm_rope(img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos, txt_sin,
                 eps: float = 1e-6, slim_base: int = 0):
    """q, k, v for the joint attention from the QKV projections.

    img_qkv [B, S_i, 3 N D], txt_qkv [B, S_t, 3 N D] (q heads, k heads, v
    heads); gains the (image q, image k, text q, text k) RMSNorm scales
    [D]; each stream's cos / sin [S, D / 2], or [B or 1, 1, S, D / 2] for a
    table per batch row.  Returns q [B, N, S_t + S_i, D] (or [B, N,
    slim_base, D], the first image rows, when ``slim_base > 0``), k and v
    [B, N, S_t + S_i, D], contiguous.  The kernel has no backward, so it
    serves calls made with grad off; with grad on, or on CPU tensors, the
    plain version."""
    if img_qkv.device.type == "cpu" or torch.is_grad_enabled():
        return qk_norm_rope_reference(img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos,
                                      txt_sin, eps, slim_base)
    return _qk_norm_rope_cuda(img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos, txt_sin,
                              eps, slim_base)


def qk_norm_rope_joint(qkv, s_t: int, gains, img_cos, img_sin, txt_cos, txt_sin,
                       eps: float = 1e-6, slim_base: int = 0):
    """q, k, v of a single-stream block: qkv [B, S_t + S_i, 3 N D], the text
    rows first; gains the (q, k) RMSNorm scales [D], shared by both parts;
    the tables as :func:`qk_norm_rope`'s.  The two parts are views of
    ``qkv`` handed to :func:`qk_norm_rope` as its two streams."""
    return qk_norm_rope(qkv[:, s_t:], qkv[:, :s_t], tuple(gains) * 2, img_cos, img_sin,
                        txt_cos, txt_sin, eps, slim_base)
