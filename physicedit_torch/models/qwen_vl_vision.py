"""Qwen2.5-VL vision tower (``physicedit_tpu/models/qwen_vl_vision.py``).

A 32-block ViT with windowed attention (full attention in four blocks)
and a 2x2 spatial-merge projector to the text width.  The ragged
bookkeeping (window permutation, segment ids, 2D RoPE) is computed on the
host in NumPy, as in the JAX package; the attention is plain PyTorch over a
segment-masked dense score matrix (the JAX package leaves it to XLA).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    num_heads: int = 16
    intermediate_size: int = 3420
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    rope_theta: float = 10000.0
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def merge_unit(self):
        return self.spatial_merge_size ** 2

    @property
    def patch_dim(self):
        return 3 * self.temporal_patch_size * self.patch_size ** 2


QWEN25_VL_VISION = QwenVLVisionConfig()

TINY_VISION = QwenVLVisionConfig(depth=2, hidden_size=32, num_heads=2,
                                 intermediate_size=64, window_size=28,
                                 fullatt_block_indexes=(1,), out_hidden_size=64)


def vision_geometry(cfg: QwenVLVisionConfig, grid_thw: list[tuple[int, int, int]]):
    """Host geometry for one set of image grids.

    Returns window_index / reverse_index (merged-token permutation and its
    inverse), win_seg / full_seg (per-patch segment ids in permuted order)
    and cos / sin [N, head_dim] RoPE tables in permuted order.
    """
    m = cfg.spatial_merge_size
    win = cfg.window_size // m // cfg.patch_size
    pos_ids, window_index, win_seg_merged, full_seg_merged = [], [], [], []
    base = 0
    win_id = 0
    for img_i, (t, h, w) in enumerate(grid_thw):
        hpos = np.arange(h)[:, None].repeat(w, 1).reshape(h // m, m, w // m, m)
        hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.arange(w)[None, :].repeat(h, 0).reshape(h // m, m, w // m, m)
        wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
        pos_ids.append(np.tile(np.stack([hpos, wpos], -1), (t, 1)))

        lh, lw = h // m, w // m
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % win, (-lw) % win
        nh, nw = (lh + pad_h) // win, (lw + pad_w) // win
        padded = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
        padded = padded.reshape(t, nh, win, nw, win).transpose(0, 1, 3, 2, 4)
        for row in padded.reshape(t * nh * nw, win * win):
            valid = row[row != -100]
            if valid.size:
                window_index.append(valid + base)
                win_seg_merged.append(np.full(valid.size, win_id))
                win_id += 1
        full_seg_merged.append(np.full(t * lh * lw, img_i))
        base += t * lh * lw

    window_index = np.concatenate(window_index)
    reverse_index = np.argsort(window_index)
    win_seg_merged = np.concatenate(win_seg_merged)
    full_seg_merged = np.concatenate(full_seg_merged)[window_index]

    pos_ids = np.concatenate(pos_ids, 0)
    max_grid = max(max(h, w) for _, h, w in grid_thw)
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, half, 2) / half))
    table = np.outer(np.arange(max_grid), inv_freq)
    rope = table[pos_ids].reshape(pos_ids.shape[0], -1)
    mu = cfg.merge_unit
    n = pos_ids.shape[0]
    rope = rope.reshape(n // mu, mu, -1)[window_index].reshape(n, -1)
    emb = np.concatenate([rope, rope], -1)
    return {
        "window_index": window_index,
        "reverse_index": reverse_index,
        "win_seg": np.repeat(win_seg_merged, mu),
        "full_seg": np.repeat(full_seg_merged, mu),
        "cos": np.cos(emb).astype(np.float32),
        "sin": np.sin(emb).astype(np.float32),
    }


def seg_bias(seg: np.ndarray) -> np.ndarray:
    """[N] segment ids -> [N, N] additive attention bias."""
    return np.where(seg[:, None] == seg[None, :], 0.0, -1e30).astype(np.float32)


class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = Leaf(scale=(d,), dtype=dtype)
        self.qkv = linear(d, 3 * d, dtype=dtype)
        self.proj = linear(d, d, dtype=dtype)
        self.norm2 = Leaf(scale=(d,), dtype=dtype)
        self.mlp = nn.ModuleDict({"gate": linear(d, cfg.intermediate_size, dtype=dtype),
                                  "up": linear(d, cfg.intermediate_size, dtype=dtype),
                                  "down": linear(cfg.intermediate_size, d, dtype=dtype)})

    def forward(self, x, cos, sin, bias):
        cfg = self.cfg
        n_tok = x.shape[0]
        nh, hd = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(rms_norm(x, self.norm1.scale, cfg.eps)).view(n_tok, 3, nh, hd)
        q, k, v = qkv.unbind(1)

        def rot(t):
            tf = t.float()
            r = torch.cat([-tf[..., hd // 2:], tf[..., :hd // 2]], -1)
            return (tf * cos[:, None, :] + r * sin[:, None, :]).to(t.dtype)

        q, k = rot(q), rot(k)
        logits = torch.einsum("qnd,knd->nqk", q.float(), k.float()) / (hd ** 0.5)
        probs = torch.softmax(logits + bias[None], dim=-1).to(v.dtype)
        out = torch.einsum("nqk,knd->qnd", probs, v).reshape(n_tok, nh * hd)
        x = x + self.proj(out)
        h = rms_norm(x, self.norm2.scale, cfg.eps)
        return x + self.mlp["down"](F.silu(self.mlp["gate"](h)) * self.mlp["up"](h))


class QwenVLVision(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, cfg: QwenVLVisionConfig = QWEN25_VL_VISION, dtype=None):
        super().__init__()
        self.cfg = cfg
        mdim = cfg.hidden_size * cfg.merge_unit
        self.patch_embed = linear(cfg.patch_dim, cfg.hidden_size, bias=False, dtype=dtype)
        self.blocks = nn.ModuleList(VisionBlock(cfg, dtype) for _ in range(cfg.depth))
        self.merger = nn.ModuleDict({
            "ln_q": Leaf(scale=(cfg.hidden_size,), dtype=dtype),
            "fc1": linear(mdim, mdim, dtype=dtype),
            "fc2": linear(mdim, cfg.out_hidden_size, dtype=dtype)})

    @torch.no_grad()
    def forward(self, patches: torch.Tensor, grid_thw: list[tuple[int, int, int]]):
        """patches [N, patch_dim] in the processor's order -> merged features
        [N / merge_unit, out_hidden] in the original order."""
        cfg = self.cfg
        dev = patches.device
        geo = vision_geometry(cfg, grid_thw)
        cos = torch.from_numpy(geo["cos"]).to(dev)
        sin = torch.from_numpy(geo["sin"]).to(dev)
        win_bias = torch.from_numpy(seg_bias(geo["win_seg"])).to(dev)
        full_bias = torch.from_numpy(seg_bias(geo["full_seg"])).to(dev)
        window_index = torch.from_numpy(geo["window_index"]).to(dev)
        reverse_index = torch.from_numpy(geo["reverse_index"]).to(dev)

        x = self.patch_embed(patches)
        n, mu = x.shape[0], cfg.merge_unit
        x = x.reshape(n // mu, mu, -1)[window_index].reshape(n, -1)
        for i, block in enumerate(self.blocks):
            bias = full_bias if i in cfg.fullatt_block_indexes else win_bias
            x = block(x, cos, sin, bias)
        x = rms_norm(x, self.merger["ln_q"].scale, cfg.eps)
        x = x.reshape(n // mu, mu * cfg.hidden_size)
        x = self.merger["fc2"](F.gelu(self.merger["fc1"](x)))
        return x[reverse_index]
