"""FastBlend video deflicker (patch-match blending)
(``physicedit_tpu/extensions/fastblend.py``).

The reference's FastBlend extension (diffsynth/extensions/FastBlend/)
embeds three CuPy RawKernel strings (cupy_kernels.py:3-119); the JAX
package replaced them with jitted XLA gathers.  Here they are loops of
``torch.gather`` over the whole batch, one gather per row of the
``patch_size``-square window; the sums still add the window's offsets one
at a time, in the JAX package's order.

Algorithm map (reference file:line):
- remap / patch_error / pairwise_patch_error kernels
  (cupy_kernels.py:3-119)                       -> _remap, _patch_error,
                                                   _pairwise_patch_error
- PatchMatcher propagation / random-search / track loop
  (patch_match.py:8-203)                        -> PatchMatcher
- PyramidPatchMatcher: area-downsampled pyramid, identity / random NNF
  init, x2 NNF upscale + bilinear fix-up (patch_match.py:206-299)
                                                -> PyramidPatchMatcher
- TableManager binary-lifting blend tables + window sums
  (runners/fast.py:8-113)                       -> TableManager
- Fast / Balanced / Accurate / Interpolation(+SingleFrame) runners
  (runners/*.py)                                -> *ModeRunner
- FastBlendSmoother pipeline hook (__init__.py:7-66) -> FastBlendSmoother

Images are float32 ``[B, H, W, C]`` in [0, 255]; an NNF is int64 ``[B, H,
W, 2]`` of source coordinates, ``[..., 0]`` the row and ``[..., 1]`` the
column (``_gather2d`` indexes ``row * width + column``).  Frames, NNFs and
blend tables stay on the runner's device (``device``, the card unless a
caller passes ``"cpu"``) from upload to the uint8 result.  The random
search draws from a host ``np.random.default_rng(seed)`` in the JAX
package's order and shape, so the NNFs can be held equal to JAX's.
"""

from __future__ import annotations

import os

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Gather primitives (the CuPy RawKernel replacements)
# ---------------------------------------------------------------------------

def _gather2d(img, xi, yi):
    """img: [B, Hp, Wp, C]; xi (rows) / yi (columns): [B, H, W, ...] ->
    [B, H, W, ..., C]."""
    return _gather_flat(img, xi * img.shape[2] + yi)


def _gather_flat(img, idx):
    """img: [B, Hp, Wp, C]; idx: [B, H, W, ...] flat positions -> [B, H, W, ..., C]."""
    b, hp, wp, c = img.shape
    out = img.reshape(b, hp * wp, c).gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def _window_cols(img, px: int, pad_size: int, h: int, w: int, r: int):
    """[B, h, w, P, ...] view of a padded ``img`` at every (x + px, y + py),
    py in [-r, r]: one row of the window, no copy."""
    rows = img[:, pad_size + px:pad_size + px + h]
    view = rows.unfold(2, w, 1)[:, :, pad_size - r:pad_size + r + 1]     # [B, h, P, ..., w]
    return view.movedim(-1, 2)


def _remap(source_pad, nnf, patch_size: int, pad_size: int):
    """remap kernel (cupy_kernels.py:3-43): target(x,y) = mean over the
    interior-clamped window of source[nnf(x+p) - p], skipping mapped
    coordinates that fall outside the image.  Returns a PADDED target
    (zeros in the pad ring), the reference's buffer layout.

    A row of the window (``patch_size`` offsets) is one gather; the sum
    still adds the offsets one at a time, in the JAX package's order."""
    b, hp, wp, c = source_pad.shape
    h, w = hp - 2 * pad_size, wp - 2 * pad_size
    r = (patch_size - 1) // 2
    dev = source_pad.device
    gx = torch.arange(h, device=dev)[:, None, None]
    gy = torch.arange(w, device=dev)[None, :, None]
    py = torch.arange(-r, r + 1, device=dev)
    cols_ok = (gy + py >= 0) & (gy + py < w)                             # [1, w, P]
    # the NNF at the clamped window position (x+px, y+py): the NNF with its
    # edges repeated r times
    nnf_rep = nnf[:, (torch.arange(-r, h + r, device=dev)).clamp(0, h - 1)][
        :, :, (torch.arange(-r, w + r, device=dev)).clamp(0, w - 1)]
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    num = torch.zeros((b, h, w, 1), dtype=torch.float32, device=dev)
    for px in range(-r, r + 1):
        shifted = _window_cols(nnf_rep, px, r, h, w, r)                  # [B, h, w, P, 2]
        nnf_x, nnf_y = shifted[..., 0] - px, shifted[..., 1] - py
        ok = (cols_ok & (gx + px >= 0) & (gx + px < h) & (nnf_x >= 0) & (nnf_x < h)
              & (nnf_y >= 0) & (nnf_y < w))
        val = _gather2d(source_pad, nnf_x.clamp(0, h - 1) + pad_size,
                        nnf_y.clamp(0, w - 1) + pad_size)                # [B, h, w, P, C]
        okf = ok.to(torch.float32)[..., None]
        val = val * okf
        for j in range(patch_size):
            acc += val[..., j, :]
        num += okf.sum(3)       # counts: exact in any order
    target = acc / num.clamp_min(1.0)
    return torch.nn.functional.pad(target, (0, 0, pad_size, pad_size, pad_size, pad_size))


def _window_error(a_pad, idx_a, b_pad, idx_b, patch_size: int, pad_size: int):
    """Sum over the window offsets of |a[idx_a + off] - b[idx_b + off]|^2,
    the channels summed per offset, the offsets added one at a time in
    JAX's order (a row of the window is one gather).  ``idx_*`` are flat
    positions of the window centres in the padded images, or None where the
    centres are the identity grid (a view of the image, no gather)."""
    b, hp, wp, c = a_pad.shape
    h, w = hp - 2 * pad_size, wp - 2 * pad_size
    r = (patch_size - 1) // 2
    py = torch.arange(-r, r + 1, device=a_pad.device)
    err = torch.zeros((b, h, w), dtype=torch.float32, device=a_pad.device)

    def row(img, idx, px):
        if idx is None:
            return _window_cols(img, px, pad_size, h, w, r)
        return _gather_flat(img, idx[..., None] + (px * wp + py))

    for px in range(-r, r + 1):
        sq = (row(a_pad, idx_a, px) - row(b_pad, idx_b, px)).square().sum(-1)  # [B, h, w, P]
        for j in range(patch_size):
            err += sq[..., j]
    return err


def _nnf_index(nnf, pad_size: int, wp: int):
    return (nnf[..., 0] + pad_size) * wp + (nnf[..., 1] + pad_size)


def _patch_error(source_pad, nnf, target_pad, patch_size: int, pad_size: int):
    """patch_error kernel (cupy_kernels.py:46-79): SSD over the FULL
    (zero-padded) window between the target patch at (x,y) and the source
    patch at nnf(x,y)."""
    return _window_error(target_pad, None, source_pad,
                         _nnf_index(nnf, pad_size, source_pad.shape[2]), patch_size, pad_size)


def _pairwise_patch_error(sa_pad, nnf_a, sb_pad, nnf_b, patch_size: int, pad_size: int):
    """pairwise_patch_error kernel (cupy_kernels.py:82-119): SSD between
    source_a at nnf_a and source_b at nnf_b."""
    wp = sa_pad.shape[2]
    return _window_error(sa_pad, _nnf_index(nnf_a, pad_size, wp), sb_pad,
                         _nnf_index(nnf_b, pad_size, wp), patch_size, pad_size)


# ---------------------------------------------------------------------------
# Patch matcher (patch_match.py:8-203)
# ---------------------------------------------------------------------------

class PatchMatcher:
    def __init__(self, height, width, channel, minimum_patch_size,
                 num_iter=5, guide_weight=10.0, random_search_steps=3,
                 random_search_range=4, use_mean_target_style=False,
                 use_pairwise_patch_error=False, tracking_window_size=0,
                 rng=None):
        self.height = height
        self.width = width
        self.channel = channel
        self.minimum_patch_size = minimum_patch_size
        self.num_iter = num_iter
        self.guide_weight = guide_weight
        self.random_search_steps = random_search_steps
        self.random_search_range = random_search_range
        self.use_mean_target_style = use_mean_target_style
        self.use_pairwise_patch_error = use_pairwise_patch_error
        self.tracking_window_size = tracking_window_size
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.patch_size_list = [minimum_patch_size + i * 2
                                for i in range(num_iter)][::-1]
        self.pad_size = self.patch_size_list[0] // 2
        self.patch_size = self.patch_size_list[0]

    def pad_image(self, image):
        p = self.pad_size
        return torch.nn.functional.pad(image.float(), (0, 0, p, p, p, p))

    def unpad_image(self, image):
        p = self.pad_size
        return image[:, p:-p, p:-p, :]

    def apply_nnf_to_image(self, nnf, source_pad):
        return _remap(source_pad, nnf, self.patch_size, self.pad_size)

    def get_error(self, source_guide, target_guide, source_style, target_style, nnf):
        error_guide = _patch_error(source_guide, nnf, target_guide,
                                   self.patch_size, self.pad_size)
        if self.use_mean_target_style:
            target_style = self.apply_nnf_to_image(nnf, source_style)
            target_style = target_style.mean(0, keepdim=True).expand_as(target_style)
        if self.use_pairwise_patch_error:
            err_half = _pairwise_patch_error(
                source_style[0::2], nnf[0::2], source_style[1::2], nnf[1::2],
                self.patch_size, self.pad_size)
            error_style = err_half.repeat_interleave(2, 0)
        else:
            error_style = _patch_error(source_style, nnf, target_style,
                                       self.patch_size, self.pad_size)
        return error_guide * self.guide_weight + error_style

    def clamp_bound(self, nnf):
        return torch.stack([nnf[..., 0].clamp(0, self.height - 1),
                            nnf[..., 1].clamp(0, self.width - 1)], -1)

    def random_step(self, nnf, r):
        step = torch.from_numpy(self.rng.integers(-r, r + 1, size=tuple(nnf.shape),
                                                  dtype=np.int32))
        if nnf.is_cuda:      # staged through pinned memory: the upload does not wait
            step = step.pin_memory()
        return self.clamp_bound(nnf + step.to(nnf.device, non_blocking=True))

    def neighboor_step(self, nnf, d):
        upd = {0: lambda: torch.cat([nnf[:, :1], nnf[:, :-1]], 1),
               1: lambda: torch.cat([nnf[:, :, :1], nnf[:, :, :-1]], 2),
               2: lambda: torch.cat([nnf[:, 1:], nnf[:, -1:]], 1),
               3: lambda: torch.cat([nnf[:, :, 1:], nnf[:, :, -1:]], 2)}[d]()
        upd[..., d % 2] += 1 if d < 2 else -1
        return self.clamp_bound(upd)

    def shift_nnf(self, nnf, d):
        if d > 0:
            d = min(nnf.shape[0], d)
            return torch.cat([nnf[d:]] + [nnf[-1:]] * d, 0)
        d = max(-nnf.shape[0], d)
        return torch.cat([nnf[:1]] * (-d) + [nnf[:d]], 0)

    def track_step(self, nnf, d):
        if self.use_pairwise_patch_error:
            upd = torch.zeros_like(nnf)
            upd[0::2] = self.shift_nnf(nnf[0::2], d)
            upd[1::2] = self.shift_nnf(nnf[1::2], d)
            return upd
        return self.shift_nnf(nnf, d)

    def update(self, sg, tg, ss, ts, nnf, err, upd_nnf):
        upd_err = self.get_error(sg, tg, ss, ts, upd_nnf)
        better = upd_err < err
        return torch.where(better[..., None], upd_nnf, nnf), torch.where(better, upd_err, err)

    def iteration(self, sg, tg, ss, ts, nnf, err):
        for d in self.rng.permutation(4):
            nnf, err = self.update(sg, tg, ss, ts, nnf, err, self.neighboor_step(nnf, int(d)))
        for _ in range(self.random_search_steps):
            nnf, err = self.update(sg, tg, ss, ts, nnf, err,
                                   self.random_step(nnf, self.random_search_range))
        for d in range(1, self.tracking_window_size + 1):
            nnf, err = self.update(sg, tg, ss, ts, nnf, err, self.track_step(nnf, d))
            nnf, err = self.update(sg, tg, ss, ts, nnf, err, self.track_step(nnf, -d))
        return nnf, err

    def estimate_nnf(self, source_guide, target_guide, source_style, nnf):
        sg = self.pad_image(source_guide)
        tg = self.pad_image(target_guide)
        ss = self.pad_image(source_style)
        for it in range(self.num_iter):
            self.patch_size = self.patch_size_list[it]
            ts = self.apply_nnf_to_image(nnf, ss)
            err = self.get_error(sg, tg, ss, ts, nnf)
            nnf, err = self.iteration(sg, tg, ss, ts, nnf, err)
        target_style = self.unpad_image(self.apply_nnf_to_image(nnf, ss))
        return nnf, target_style


# ---------------------------------------------------------------------------
# Pyramid (patch_match.py:206-299)
# ---------------------------------------------------------------------------

def _area_resize(images, height, width):
    """torch F.interpolate(mode='area') == adaptive average pooling, as the
    JAX package computes it: output cell (i, j) averages input rows
    [floor(iH/H'), ceil((i+1)H/H')), from a prefix sum."""
    images = images.float()
    b, h, w, c = images.shape
    if (h, w) == (height, width):
        return images

    def pool_axis(x, size, axis):
        n = x.shape[axis]
        cs = torch.cumsum(x, axis)
        cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], axis)
        starts = np.floor(np.arange(size) * n / size).astype(np.int64)
        ends = np.ceil((np.arange(size) + 1) * n / size).astype(np.int64)
        hi = cs.index_select(axis, torch.from_numpy(ends).to(x.device))
        lo = cs.index_select(axis, torch.from_numpy(starts).to(x.device))
        shape = [1] * x.ndim
        shape[axis] = size
        cnt = torch.from_numpy((ends - starts).astype(np.float32)).to(x.device)
        return (hi - lo) / cnt.reshape(shape)

    return pool_axis(pool_axis(images, height, 1), width, 2)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] fp32 weight matrix of ``jax.image.resize``'s
    bilinear (triangle) kernel, computed as JAX computes it (half-pixel
    sample points, weights renormalised where the kernel leaves the input,
    zero outside it; ``antialias`` widens the kernel only when shrinking)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def _resize_nnf(nnf, height: int, width: int):
    """``jax.image.resize(nnf.astype(float32), (B, height, width, 2),
    "bilinear").astype(int32)``: the columns, then the rows (JAX's order of
    contraction), through the kernel's weight matrices; an axis of the same
    size is left alone."""
    x = nnf.to(torch.float32)
    if x.shape[2] != width:
        ww = torch.from_numpy(_resize_weights(x.shape[2], width)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    if x.shape[1] != height:
        wh = torch.from_numpy(_resize_weights(x.shape[1], height)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    return x.to(torch.int32).to(nnf.dtype)


class PyramidPatchMatcher:
    def __init__(self, image_height, image_width, channel, minimum_patch_size,
                 threads_per_block=8, num_iter=5, gpu_id=0, guide_weight=10.0,
                 use_mean_target_style=False, use_pairwise_patch_error=False,
                 tracking_window_size=0, initialize="identity", seed=0, device="cuda"):
        del threads_per_block, gpu_id   # the reference's CuPy launch geometry
        maximum_patch_size = minimum_patch_size + (num_iter - 1) * 2
        # >= 1 level: frames smaller than ~2x the largest patch would give
        # log2 <= 0 and skip estimation entirely
        self.pyramid_level = max(1, int(np.log2(
            min(image_height, image_width) / maximum_patch_size)))
        self.pyramid_heights = []
        self.pyramid_widths = []
        self.patch_matchers = []
        self.minimum_patch_size = minimum_patch_size
        self.num_iter = num_iter
        self.initialize = initialize
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        for level in range(self.pyramid_level):
            height = image_height // (2 ** (self.pyramid_level - 1 - level))
            width = image_width // (2 ** (self.pyramid_level - 1 - level))
            self.pyramid_heights.append(height)
            self.pyramid_widths.append(width)
            self.patch_matchers.append(PatchMatcher(
                height, width, channel, minimum_patch_size=minimum_patch_size,
                num_iter=num_iter, guide_weight=guide_weight,
                use_mean_target_style=use_mean_target_style,
                use_pairwise_patch_error=use_pairwise_patch_error,
                tracking_window_size=tracking_window_size, rng=self.rng))

    def initialize_nnf(self, batch_size):
        height, width = self.pyramid_heights[0], self.pyramid_widths[0]
        if self.initialize == "random":
            nnf = np.stack([
                self.rng.integers(0, height, (batch_size, height, width)),
                self.rng.integers(0, width, (batch_size, height, width)),
            ], axis=3)
            return torch.from_numpy(nnf).to(self.device, torch.int64)
        if self.initialize == "identity":
            gx = torch.arange(height, device=self.device)[None, :, None].expand(
                batch_size, height, width)
            gy = torch.arange(width, device=self.device)[None, None, :].expand_as(gx)
            return torch.stack([gx, gy], -1)
        raise NotImplementedError(self.initialize)

    def update_nnf(self, nnf, level):
        # x2 upscale with sub-pixel offsets (patch_match.py:261-275)
        nnf = nnf.repeat_interleave(2, 1).repeat_interleave(2, 2) * 2
        nnf[:, 1::2, :, 0] += 1
        nnf[:, :, 1::2, 1] += 1
        height, width = self.pyramid_heights[level], self.pyramid_widths[level]
        if (height, width) != tuple(nnf.shape[1:3]):
            nnf = self.patch_matchers[level].clamp_bound(_resize_nnf(nnf, height, width))
        return nnf

    def estimate_nnf(self, source_guide, target_guide, source_style):
        """Frames [B, H, W, C] (tensors on the device) -> (NNF, the source
        style remapped through it), both on the device."""
        nnf = target_style = None
        for level in range(self.pyramid_level):
            nnf = (self.initialize_nnf(source_guide.shape[0]) if level == 0
                   else self.update_nnf(nnf, level))
            h, w = self.pyramid_heights[level], self.pyramid_widths[level]
            nnf, target_style = self.patch_matchers[level].estimate_nnf(
                _area_resize(source_guide, h, w), _area_resize(target_guide, h, w),
                _area_resize(source_style, h, w), nnf)
        return nnf, target_style


# ---------------------------------------------------------------------------
# Runners (runners/fast.py, balanced.py, accurate.py, interpolation.py)
# ---------------------------------------------------------------------------

def _upload(frames, device):
    """Frames (HxWx3 arrays) -> one float32 [N, H, W, 3] tensor on ``device``."""
    return torch.from_numpy(np.stack([np.asarray(f, np.float32) for f in frames])).to(device)


def _to_uint8(frame):
    """Clip, then truncate (the reference's ``.clip(0, 255).astype("uint8")``)."""
    return frame.clamp(0, 255).to(torch.uint8)


def _save_frame(frame, save_path, index):
    if save_path is not None:
        from PIL import Image

        Image.fromarray(frame.cpu().numpy()).save(os.path.join(save_path, "%05d.png" % index))


class TableManager:
    """Binary-lifting remapping / blending tables (runners/fast.py:8-113)."""

    def task_list(self, n):
        tasks = []
        max_level = 1
        while (1 << max_level) <= n:
            max_level += 1
        for i in range(n):
            j = i
            for level in range(max_level):
                if i & (1 << level):
                    continue
                j |= 1 << level
                if j >= n:
                    break
                tasks.append({"source": i, "target": j, "level": level + 1})
        tasks.sort(key=lambda u: u["level"])
        return tasks

    def build_remapping_table(self, frames_guide, frames_style, engine, batch_size):
        n = len(frames_guide)
        tasks = self.task_list(n)
        table = [[(frames_style[i], 1)] for i in range(n)]
        for bi in range(0, len(tasks), batch_size):
            batch = tasks[bi: bi + batch_size]
            _, ts = engine.estimate_nnf(frames_guide[[t["source"] for t in batch]],
                                        frames_guide[[t["target"] for t in batch]],
                                        frames_style[[t["source"] for t in batch]])
            for t, result in zip(batch, ts):
                target, level = t["target"], t["level"]
                if len(table[target]) == level:
                    table[target].append((result, 1))
                else:
                    frame, weight = table[target][level]
                    table[target][level] = (
                        frame * (weight / (weight + 1)) + result / (weight + 1), weight + 1)
        return table

    def remapping_table_to_blending_table(self, table):
        for i in range(len(table)):
            for j in range(1, len(table[i])):
                f1, w1 = table[i][j - 1]
                f2, w2 = table[i][j]
                table[i][j] = ((f1 + f2) / 2, w1 + w2)
        return table

    def tree_query(self, leftbound, rightbound):
        node_list = []
        node_index = rightbound
        while node_index >= leftbound:
            node_level = 0
            while ((1 << node_level) & node_index
                   and node_index - (1 << (node_level + 1)) + 1 >= leftbound):
                node_level += 1
            node_list.append((node_index, node_level))
            node_index -= 1 << node_level
        return node_list

    def process_window_sum(self, frames_guide, blending_table, engine, window_size,
                           batch_size):
        n = len(blending_table)
        tasks = []
        frames_result = []
        for target in range(n):
            for source, level in self.tree_query(max(target - window_size, 0), target):
                if source != target:
                    tasks.append({"source": source, "target": target, "level": level})
                else:
                    frames_result.append(blending_table[target][level])
        for bi in range(0, len(tasks), batch_size):
            batch = tasks[bi: bi + batch_size]
            _, ts = engine.estimate_nnf(
                frames_guide[[t["source"] for t in batch]],
                frames_guide[[t["target"] for t in batch]],
                torch.stack([blending_table[t["source"]][t["level"]][0] for t in batch]))
            for t, frame_2 in zip(batch, ts):
                source, target, level = t["source"], t["target"], t["level"]
                frame_1, weight_1 = frames_result[target]
                weight_2 = blending_table[source][level][1]
                weight = weight_1 + weight_2
                frames_result[target] = (
                    frame_1 * (weight_1 / weight) + frame_2 * (weight_2 / weight), weight)
        return frames_result


def _default_config():
    return {"minimum_patch_size": 5, "num_iter": 5, "guide_weight": 10.0,
            "initialize": "identity", "tracking_window_size": 0}


def _engine_kwargs(ebsynth_config):
    kw = dict(_default_config())
    kw.update(ebsynth_config or {})
    kw.pop("threads_per_block", None)
    kw.pop("gpu_id", None)
    return kw


def _engine(frames, device, ebsynth_config, **flags):
    return PyramidPatchMatcher(image_height=frames.shape[1], image_width=frames.shape[2],
                               channel=3, device=device, **flags,
                               **_engine_kwargs(ebsynth_config))


class FastModeRunner:
    """O(n log n) two-direction binary-lifting blend (runners/fast.py:116-150)."""

    def run(self, frames_guide, frames_style, batch_size, window_size,
            ebsynth_config, save_path=None, device="cuda"):
        frames_guide = _upload(frames_guide, device)
        frames_style = _upload(frames_style, device)
        tm = TableManager()
        engine = _engine(frames_style, device, ebsynth_config)
        table_l = tm.build_remapping_table(frames_guide, frames_style, engine, batch_size)
        table_l = tm.remapping_table_to_blending_table(table_l)
        table_l = tm.process_window_sum(frames_guide, table_l, engine, window_size, batch_size)
        guide_r, style_r = frames_guide.flip(0), frames_style.flip(0)
        table_r = tm.build_remapping_table(guide_r, style_r, engine, batch_size)
        table_r = tm.remapping_table_to_blending_table(table_r)
        table_r = tm.process_window_sum(guide_r, table_r, engine, window_size,
                                        batch_size)[::-1]
        frames = []
        for (f_l, w_l), f_m, (f_r, w_r) in zip(table_l, frames_style, table_r):
            w_m = -1  # the style frame was double-counted in both tables
            weight = w_l + w_m + w_r
            frames.append(_to_uint8(f_l * (w_l / weight) + f_m * (w_m / weight)
                                    + f_r * (w_r / weight)))
        for i, f in enumerate(frames):
            _save_frame(f, save_path, i)
        return [f.cpu().numpy() for f in frames]


class BalancedModeRunner:
    """O(n * window) symmetric-window average (runners/balanced.py)."""

    def run(self, frames_guide, frames_style, batch_size, window_size,
            ebsynth_config, save_path=None, device="cuda"):
        frames_guide = _upload(frames_guide, device)
        frames_style = _upload(frames_style, device)
        engine = _engine(frames_style, device, ebsynth_config)
        n = len(frames_style)
        tasks = [(s, t) for t in range(n)
                 for s in range(t - window_size, t + window_size + 1)
                 if 0 <= s < n and s != t]
        acc = [(frames_style[i], 1) for i in range(n)]
        out = [None] * n
        for bi in range(0, len(tasks), batch_size):
            batch = tasks[bi: bi + batch_size]
            _, ts = engine.estimate_nnf(frames_guide[[s for s, _ in batch]],
                                        frames_guide[[t for _, t in batch]],
                                        frames_style[[s for s, _ in batch]])
            for (s, t), result in zip(batch, ts):
                frame, weight = acc[t]
                acc[t] = (frame * (weight / (weight + 1)) + result / (weight + 1), weight + 1)
                full = min(n, t + window_size + 1) - max(0, t - window_size)
                if weight + 1 == full:
                    out[t] = _to_uint8(acc[t][0])
                    _save_frame(out[t], save_path, t)
        for t in range(n):  # frames whose window never filled (tiny n)
            if out[t] is None:
                out[t] = _to_uint8(acc[t][0])
                _save_frame(out[t], save_path, t)
        return [f.cpu().numpy() for f in out]


class AccurateModeRunner:
    """O(n * window) mean-target-style remap (runners/accurate.py)."""

    def run(self, frames_guide, frames_style, batch_size, window_size,
            ebsynth_config, save_path=None, device="cuda"):
        frames_guide = _upload(frames_guide, device)
        frames_style = _upload(frames_style, device)
        engine = _engine(frames_style, device, ebsynth_config, use_mean_target_style=True)
        n = len(frames_style)
        out = []
        for target in range(n):
            l, r = max(target - window_size, 0), min(target + window_size + 1, n)
            remapped = []
            for i in range(l, r, batch_size):
                j = min(i + batch_size, r)
                _, ts = engine.estimate_nnf(frames_guide[i:j],
                                            frames_guide[[target] * (j - i)],
                                            frames_style[i:j])
                remapped.append(ts)
            frame = _to_uint8(torch.cat(remapped).mean(0))
            out.append(frame)
            _save_frame(frame, save_path, target)
        return [f.cpu().numpy() for f in out]


class InterpolationModeRunner:
    """Keyframe interpolation with pairwise patch error (runners/interpolation.py)."""

    def get_weight(self, l, m, r):
        weight_l, weight_r = abs(m - r), abs(m - l)
        if weight_l + weight_r == 0:
            return 0.5, 0.5
        return weight_l / (weight_l + weight_r), weight_r / (weight_l + weight_r)

    def get_task_group(self, index_style, n):
        task_group = []
        index_style = sorted(index_style)
        if index_style[0] > 0:
            task_group.append([(index_style[0], m, index_style[0])
                               for m in range(index_style[0])])
        for l, r in zip(index_style[:-1], index_style[1:]):
            task_group.append([(l, m, r) for m in range(l, r)])
        task_group.append([(index_style[-1], m, index_style[-1])
                           for m in range(index_style[-1], n)])
        return task_group

    def run(self, frames_guide, frames_style, index_style, batch_size,
            ebsynth_config, save_path=None, device="cuda"):
        frames_guide = _upload(frames_guide, device)
        frames_style = _upload(frames_style, device)
        engine = _engine(frames_style, device, ebsynth_config, use_pairwise_patch_error=True)
        index_dict = {index: i for i, index in enumerate(index_style)}
        out = [None] * len(frames_guide)
        for tasks in self.get_task_group(index_style, len(frames_guide)):
            for bi in range(0, len(tasks), batch_size):
                batch = tasks[bi: bi + batch_size]
                sg, tg, ss = [], [], []
                for l, m, r in batch:
                    sg += [l, r]
                    tg += [m, m]
                    ss += [index_dict[l], index_dict[r]]
                _, ts = engine.estimate_nnf(frames_guide[sg], frames_guide[tg],
                                            frames_style[ss])
                for f_l, f_r, (l, m, r) in zip(ts[0::2], ts[1::2], batch):
                    w_l, w_r = self.get_weight(l, m, r)
                    out[m] = _to_uint8(f_l * w_l + f_r * w_r)
                    _save_frame(out[m], save_path, m)
        return [f.cpu().numpy() for f in out]


class InterpolationModeSingleFrameRunner:
    """One style keyframe tracked across the whole video
    (runners/interpolation.py:88-121)."""

    def run(self, frames_guide, frames_style, index_style, batch_size,
            ebsynth_config, save_path=None, device="cuda"):
        cfg = _engine_kwargs(ebsynth_config)
        tws = cfg.get("tracking_window_size", 0)
        if tws * 2 >= batch_size:
            raise ValueError("batch_size should be larger than tracking_window_size * 2")
        frames_guide = _upload(frames_guide, device)
        frame_style = _upload(frames_style[:1], device)
        frame_guide = frames_guide[index_style[0]:index_style[0] + 1]
        engine = _engine(frame_style, device, ebsynth_config)
        frame_id, n = 0, len(frames_guide)
        out = [None] * n
        for i in range(0, n, batch_size - tws * 2):
            l, r = (max(n - batch_size, 0), n) if i + batch_size > n else (i, i + batch_size)
            _, ts = engine.estimate_nnf(frame_guide.expand(r - l, -1, -1, -1),
                                        frames_guide[l:r],
                                        frame_style.expand(r - l, -1, -1, -1))
            for j, frame in zip(range(l, r), ts):
                if j == frame_id:
                    out[frame_id] = _to_uint8(frame)
                    _save_frame(out[frame_id], save_path, frame_id)
                    frame_id += 1
                if r < n and r - frame_id <= tws:
                    break
            if frame_id >= n:
                break
        return [f.cpu().numpy() for f in out]


# ---------------------------------------------------------------------------
# Functional API + pipeline hook (api.py:26-131, __init__.py:7-66)
# ---------------------------------------------------------------------------

def smooth_video(frames_guide, frames_style, mode="Fast", window_size=15,
                 batch_size=8, tracking_window_size=0, minimum_patch_size=5,
                 num_iter=5, guide_weight=10.0, initialize="identity",
                 save_path=None, device="cuda"):
    """Deflicker ``frames_style`` using ``frames_guide`` as motion guidance.

    Frames are HxWx3 uint8 / float arrays (all the same shape); returns the
    blended frames as uint8 arrays.  Mirrors api.py:26-131 minus the gradio
    UI / ffmpeg output plumbing.
    """
    config = {
        "minimum_patch_size": minimum_patch_size,
        "num_iter": num_iter,
        "guide_weight": guide_weight,
        "initialize": initialize,
        "tracking_window_size": 0 if mode in ("Fast", "Balanced") else tracking_window_size,
    }
    runner = {"Fast": FastModeRunner, "Balanced": BalancedModeRunner,
              "Accurate": AccurateModeRunner}[mode]()
    return runner.run(frames_guide, frames_style, batch_size=batch_size,
                      window_size=window_size, ebsynth_config=config,
                      save_path=save_path, device=device)


def interpolate_video(frames_guide, keyframes, keyframe_indices, batch_size=8,
                      tracking_window_size=0, minimum_patch_size=15, num_iter=5,
                      guide_weight=10.0, initialize="identity", save_path=None,
                      device="cuda"):
    """Propagate styled keyframes across a guide video (api.py:192-247)."""
    config = {
        "minimum_patch_size": minimum_patch_size,
        "num_iter": num_iter,
        "guide_weight": guide_weight,
        "initialize": initialize,
        "tracking_window_size": tracking_window_size,
    }
    runner = (InterpolationModeSingleFrameRunner if len(keyframes) == 1
              else InterpolationModeRunner)()
    return runner.run(frames_guide, keyframes, keyframe_indices, batch_size=batch_size,
                      ebsynth_config=config, save_path=save_path, device=device)


class FastBlendSmoother:
    """Pipeline post-processing hook (FastBlend/__init__.py:7-66)."""

    def __init__(self, device="cuda"):
        self.batch_size = 8
        self.window_size = 64
        self.ebsynth_config = _default_config()
        self.device = device

    @staticmethod
    def from_model_manager(_model_manager=None, device="cuda"):
        return FastBlendSmoother(device)

    def __call__(self, rendered_frames, original_frames=None, **kwargs):
        from PIL import Image

        if original_frames is None:
            raise ValueError(
                "FastBlendSmoother needs original_frames as the motion "
                "guide (the reference hook receives them from the video "
                "pipeline, FastBlend/__init__.py:55-58)")
        frames = FastModeRunner().run(
            [np.asarray(f) for f in original_frames],
            [np.asarray(f) for f in rendered_frames],
            batch_size=self.batch_size, window_size=self.window_size,
            ebsynth_config=self.ebsynth_config, device=self.device)
        return [Image.fromarray(f) for f in frames]
