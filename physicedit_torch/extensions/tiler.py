"""Tiled inference for convolutional models (``physicedit_tpu/extensions/tiler.py``;
the reference's ``FastTileWorker`` / ``TileWorker2Dto3D``,
diffsynth/models/tiler.py:110-234).

Split a large image (or video) into overlapping spatial tiles, run a model
per tile, and blend the results with linear feathering masks so seams
vanish.  NHWC / NTHWC tensors in, a tensor out.  Every tile has the same
shape: edge tiles are clamped inward (reference tiler.py:146-148).  The
blend accumulates in fp32 in ``value`` and ``weight`` buffers on the
input's device, so a tiled run on the card makes no host round trip per
tile; the feather masks are built once per tile geometry on the host.
The model may change resolution and channel count: pass ``scales`` (C, H,
W), like the reference's 3D worker (tiler.py:199).
"""

from __future__ import annotations

import numpy as np
import torch


def _tile_tasks(size: int, tile: int, stride: int):
    """1-D clamped tile starts (reference tiler.py:141-149)."""
    tasks = []
    for lo in range(0, size, stride):
        if lo - stride >= 0 and lo - stride + tile >= size:
            continue
        hi = lo + tile
        if hi > size:
            lo, hi = max(size - tile, 0), size
        tasks.append((lo, hi))
    return tasks


def build_mask(h: int, w: int, is_bound, border_width: int | None = None):
    """Feathering mask (reference tiler.py:115-130): distance-to-edge ramp,
    clipped to [1, border]/border; edges flagged in ``is_bound``
    (top, bottom, left, right) blend at full weight.  NumPy fp32 [h, w]."""
    if border_width is None:
        border_width = (h + w) // 4
    hh = np.arange(h)[:, None] * np.ones((1, w))
    ww = np.ones((h, 1)) * np.arange(w)[None, :]
    pad = np.full((h, w), border_width, np.float64)
    mask = np.stack([
        pad if is_bound[0] else hh + 1,
        pad if is_bound[1] else h - hh,
        pad if is_bound[2] else ww + 1,
        pad if is_bound[3] else w - ww,
    ]).min(axis=0)
    return (np.clip(mask, 1, border_width) / border_width).astype(np.float32)


def _tiles(h: int, w: int, tile_size, tile_stride):
    tile_h, tile_w = (tile_size if isinstance(tile_size, (tuple, list))
                      else (tile_size, tile_size))
    stride_h, stride_w = (tile_stride if isinstance(tile_stride, (tuple, list))
                          else (tile_stride, tile_stride))
    return [(hl, hr, wl, wr)
            for hl, hr in _tile_tasks(h, tile_h, stride_h)
            for wl, wr in _tile_tasks(w, tile_w, stride_w)]


def _blend(forward_fn, x, tasks, out_shape, spatial: int, scales_hw, border_width,
           progress_bar):
    """Accumulate ``forward_fn`` over ``tasks`` into an fp32 tensor of
    ``out_shape``; ``spatial`` is the index of the H axis (1 for NHWC, 2
    for NTHWC)."""
    sh, sw = scales_hw
    h, w = x.shape[spatial], x.shape[spatial + 1]
    value = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    weight_shape = [1] * len(out_shape)
    weight_shape[1:-1] = out_shape[1:-1]
    weight = torch.zeros(weight_shape, dtype=torch.float32, device=x.device)
    lead = (slice(None),) * spatial
    masks = {}      # one upload per tile geometry
    for hl, hr, wl, wr in progress_bar(tasks):
        out = forward_fn(x[lead + (slice(hl, hr), slice(wl, wr))]).float()
        oh, ow = out.shape[spatial], out.shape[spatial + 1]
        key = (oh, ow, hl == 0, hr >= h, wl == 0, wr >= w)
        if key not in masks:
            masks[key] = torch.from_numpy(build_mask(oh, ow, key[2:], border_width)).to(
                x.device)[(None,) * spatial + (Ellipsis, None)]
        mask = masks[key]
        ohl, owl = int(hl * sh), int(wl * sw)
        region = lead + (slice(ohl, ohl + oh), slice(owl, owl + ow))
        value[region] += out * mask
        weight[region] += mask
    return value / weight


def tiled_forward(forward_fn, x: torch.Tensor, tile_size: int, tile_stride: int,
                  border_width: int | None = None, scales=(1, 1, 1),
                  progress_bar=lambda t: t) -> torch.Tensor:
    """x: [B, H, W, C] -> blended forward_fn over overlapping tiles (fp32).

    forward_fn: [B, tile, tile, C] -> [B, tile*sH, tile*sW, C*sC].
    scales: (sC, sH, sW) output/input ratios (1,1,1 for shape-preserving
    models; (1, 4, 4) for a 4x upscaler, etc.).
    """
    b, h, w, c = x.shape
    sc, sh, sw = scales
    out_shape = (b, int(h * sh), int(w * sw), int(c * sc))
    return _blend(forward_fn, x, _tiles(h, w, tile_size, tile_stride), out_shape, 1,
                  (sh, sw), border_width, progress_bar)


def tiled_forward_3d(forward_fn, x: torch.Tensor, tile_size, tile_stride,
                     border_width: int | None = None, scales=(1, 1, 1, 1),
                     progress_bar=lambda t: t) -> torch.Tensor:
    """Video variant (reference TileWorker2Dto3D, tiler.py:164-234):
    x [B, T, H, W, C], spatial-only tiling (time processed whole).

    forward_fn: [B, T, th, tw, C] -> [B, T*sT, th*sH, tw*sW, C*sC].
    scales: (sC, sT, sH, sW).
    """
    b, t, h, w, c = x.shape
    sc, st, sh, sw = scales
    out_shape = (b, int(t * st), int(h * sh), int(w * sw), int(c * sc))
    return _blend(forward_fn, x, _tiles(h, w, tile_size, tile_stride), out_shape, 2,
                  (sh, sw), border_width, progress_bar)
