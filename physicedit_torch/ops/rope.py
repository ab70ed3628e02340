"""3D rotary position embeddings for the Qwen-Image DiT
(``physicedit_tpu/ops/rope.py``) and the FLUX DiT.

The cos/sin tables are built once per request on the host in NumPy, exactly
as the JAX package builds them; :func:`apply_rope` rotates adjacent pairs
of the head dim in fp32 on the device.  :func:`flux_rope_tables` gives
FLUX.1 Kontext's position ids (diffusers' ``FluxKontextPipeline``) on the
same axes and rotation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

AXES_DIM = (16, 56, 56)
THETA = 10000.0


def _rope_angles(index: np.ndarray, dim: int, theta: float = THETA) -> np.ndarray:
    """outer(index, theta^(-2i/dim)) -> [len(index), dim // 2]."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(index.astype(np.float64), inv_freq)


def _axis_angles(index: np.ndarray, axes_dim: tuple = AXES_DIM) -> np.ndarray:
    return np.concatenate([_rope_angles(index, d) for d in axes_dim], axis=1)


@functools.lru_cache(maxsize=64)
def _video_angles(idx: int, frame: int, height: int, width: int,
                  axes_dim: tuple = AXES_DIM) -> np.ndarray:
    """Angles for one image: [frame * height * width, sum(axes) // 2].

    ``idx`` (the image's place in img_shapes) is the frame coordinate; H and
    W indices are centred (scale_rope): [-(h - h//2) .. -1, 0 .. h//2 - 1].
    The cached array is read-only to its callers.
    """
    d0, d1, d2 = (d // 2 for d in axes_dim)
    f_ang = _rope_angles(np.arange(idx, idx + frame), axes_dim[0])
    h_idx = np.concatenate([np.arange(-(height - height // 2), 0), np.arange(height // 2)])
    w_idx = np.concatenate([np.arange(-(width - width // 2), 0), np.arange(width // 2)])
    out = np.empty((frame, height, width, d0 + d1 + d2), dtype=np.float64)
    out[..., :d0] = f_ang[:, None, None, :]
    out[..., d0:d0 + d1] = _rope_angles(h_idx, axes_dim[1])[None, :, None, :]
    out[..., d0 + d1:] = _rope_angles(w_idx, axes_dim[2])[None, None, :, :]
    return out.reshape(frame * height * width, d0 + d1 + d2)


def build_rope_tables(img_shapes: list[tuple[int, int, int]], txt_seq_len: int,
                      edit_rope_interpolation: bool = False,
                      axes_dim: tuple = AXES_DIM):
    """(img_cos, img_sin, txt_cos, txt_sin), each float32 [S, sum(axes)//2].

    Text positions start past the largest image index.  With
    ``edit_rope_interpolation`` the images after the first reuse a
    subsampled copy of image 0's H/W grid, keeping their own frame index.
    """
    vid = []
    max_vid_index = 0
    for idx, (frame, height, width) in enumerate(img_shapes):
        if edit_rope_interpolation and idx > 0:
            f0, h0, w0 = img_shapes[0]
            half = sum(axes_dim) // 2
            base = _video_angles(0, f0, h0, w0, axes_dim).reshape(f0, h0, w0, half)
            h_sel = np.linspace(0, h0 - 1, height).astype(np.int64)
            w_sel = np.linspace(0, w0 - 1, width).astype(np.int64)
            sampled = base[:, h_sel][:, :, w_sel].copy()
            f_ang = _rope_angles(np.arange(idx, idx + frame), axes_dim[0])
            sampled[..., :axes_dim[0] // 2] = f_ang[:, None, None, :]
            vid.append(sampled.reshape(frame * height * width, half))
        else:
            vid.append(_video_angles(idx, frame, height, width, axes_dim))
        max_vid_index = max(height // 2, width // 2, max_vid_index)

    img_ang = np.concatenate(vid, axis=0)
    txt_ang = _axis_angles(np.arange(max_vid_index, max_vid_index + txt_seq_len),
                           axes_dim)
    img_cos, img_sin = _cos_sin(img_ang)
    txt_cos, txt_sin = _cos_sin(txt_ang)
    return img_cos, img_sin, txt_cos, txt_sin


def flux_rope_tables(img_shapes: list[tuple[int, int, int]], txt_seq_len: int,
                     axes_dim: tuple = AXES_DIM):
    """(img_cos, img_sin, txt_cos, txt_sin) of the FLUX DiT, each float32
    [S, sum(axes)//2]: text ids are all zero (the identity rotation); image
    ``i`` of ``img_shapes`` (the target 0, Kontext's context image 1) takes
    the ids (i, row, column), rows and columns counted from 0, not centred."""
    vid = []
    for idx, (frame, height, width) in enumerate(img_shapes):
        ff, hh, ww = np.meshgrid(np.arange(idx, idx + frame), np.arange(height),
                                 np.arange(width), indexing="ij")
        vid.append(np.concatenate([_rope_angles(a.ravel(), d) for a, d in
                                   zip((ff, hh, ww), axes_dim)], axis=1))
    img_cos, img_sin = _cos_sin(np.concatenate(vid, axis=0))
    txt_cos, txt_sin = _cos_sin(_axis_angles(np.zeros(txt_seq_len), axes_dim))
    return img_cos, img_sin, txt_cos, txt_sin


def _cos_sin(angles: np.ndarray):
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def text_rope_tables(txt_len: int, max_vid_index: int,
                     axes_dim: tuple = AXES_DIM):
    """A text cos/sin table starting at ``max_vid_index``."""
    return _cos_sin(
        _axis_angles(np.arange(max_vid_index, max_vid_index + txt_len), axes_dim))


def max_vid_index_of(img_shapes: list, scale_rope: bool = True) -> int:
    """The first text position past the images (where each EliGen prompt
    segment's text table starts)."""
    return max((max(h // 2, w // 2) if scale_rope else max(h, w)) for _, h, w in img_shapes)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs (x[2i], x[2i+1]) of the last dim in fp32 and
    return the input dtype.  x: [B, N, S, D]; cos/sin: [S, D // 2], or
    [B, 1, S, D // 2] for a table per batch row (EliGen's per-CFG-row text
    tables), broadcast over the heads."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)
