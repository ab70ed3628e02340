"""Qwen-Image's 3-axis RoPE tables (frame, height, width), worked out in
NumPy: per axis of ``d`` dims the angles ``pos * 10000^(-2i/d)``; each image
``i`` of ``[(frames, h, w), ...]`` takes frame index ``i`` and centred
height / width indices ``-(h - h//2) .. h//2 - 1``; text positions run
from ``max(h//2, w//2)`` over the images, on all three axes."""

from __future__ import annotations

import numpy as np

THETA = 10000.0


def _angles(pos: np.ndarray, dim: int) -> np.ndarray:
    inv = 1.0 / (THETA ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(pos.astype(np.float64), inv)


def tables(img_shapes: list, txt_len: int, axes: tuple = (16, 56, 56)):
    """(img_cos, img_sin, txt_cos, txt_sin), float32 [S, sum(axes) / 2]."""
    rows = []
    for i, (f, h, w) in enumerate(img_shapes):
        hi = np.concatenate([np.arange(-(h - h // 2), 0), np.arange(h // 2)])
        wi = np.concatenate([np.arange(-(w - w // 2), 0), np.arange(w // 2)])
        ff, hh, ww = np.meshgrid(np.arange(i, i + f), hi, wi, indexing="ij")
        rows.append(np.concatenate([_angles(ff.ravel(), axes[0]), _angles(hh.ravel(), axes[1]),
                                    _angles(ww.ravel(), axes[2])], axis=1))
    start = max(max(h // 2, w // 2) for _, h, w in img_shapes)
    pos = np.arange(start, start + txt_len)
    txt = np.concatenate([_angles(pos, d) for d in axes], axis=1)
    img = np.concatenate(rows, axis=0)
    return (np.cos(img).astype(np.float32), np.sin(img).astype(np.float32),
            np.cos(txt).astype(np.float32), np.sin(txt).astype(np.float32))
