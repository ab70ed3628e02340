"""DINOv2-with-registers, ViT-B/14 (``physicedit_tpu/models/dinov2.py``).

The reference's Dinov2withNorm wrapper: patch embed 14 x 14, CLS token,
learned absolute position embedding interpolated to the input grid, 4
register tokens inserted after the CLS token after the position embedding,
pre-norm blocks with LayerScale, a final LayerNorm without affine, and the
CLS and register tokens dropped from the output.  Its attention is plain
matmul + softmax (the JAX package's ``sdpa_xla``); no kernel sits here.

The JAX package runs it on fp32 pixels over weights of any dtype (``jnp``
promotes); so does this module.  The position-embedding interpolation is
``jax.image.resize(..., "bicubic")``: the Keys cubic (a = -0.5),
antialiased when it shrinks, which ``F.interpolate`` is not.  Its weights
are rebuilt in NumPy on the host (:func:`resize_weights`), a small table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, init_random_, linear, linear_promoted
from physicedit_torch.ops.attention import sdpa_bnsd
from physicedit_torch.ops.norms import layer_norm

# ImageNet normalisation of the DINO inputs
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 14
    num_register_tokens: int = 4
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def num_unused_tokens(self):
        return 1 + self.num_register_tokens


DINOV2_BASE = DinoV2Config()
# facebook/dinov2-with-registers-base: image_size 518, so a 37 x 37 table
DINOV2_BASE_POS_GRID = 37


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` float32 weights of ``jax.image.resize``
    (``compute_weight_mat`` with the Keys cubic, antialias on, no
    translation), in its float32 arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / f32(kernel_scale)
    w = _keys_cubic(x.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1).astype(f32), 0.0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def interpolate_pos_embed(pos_emb: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """[1, 1 + N0, D] (CLS first) -> [1, 1 + grid_h * grid_w, D], bicubic as
    ``jax.image.resize`` in fp32."""
    n0 = pos_emb.shape[1] - 1
    g0 = int(round(float(np.sqrt(n0))))
    if g0 * g0 == n0 and (grid_h, grid_w) == (g0, g0):
        return pos_emb
    patch = pos_emb[:, 1:].reshape(g0, g0, -1).float()
    out = patch
    if grid_h != g0:
        wh = torch.from_numpy(resize_weights(g0, grid_h)).to(pos_emb.device)
        out = torch.einsum("hwd,hy->ywd", out, wh)
    if grid_w != g0:
        ww = torch.from_numpy(resize_weights(g0, grid_w)).to(pos_emb.device)
        out = torch.einsum("ywd,wx->yxd", out, ww)
    out = out.reshape(1, grid_h * grid_w, -1).to(pos_emb.dtype)
    return torch.cat([pos_emb[:, :1], out], dim=1)


class DinoLayer(nn.Module):
    def __init__(self, cfg: DinoV2Config, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.qkv = linear(d, 3 * d, dtype=dtype)
        self.out = linear(d, d, dtype=dtype)
        self.ls1 = nn.Parameter(torch.empty((d,), dtype=dtype, device="meta"),
                                requires_grad=False)
        self.norm2 = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.fc1 = linear(d, d * cfg.mlp_ratio, dtype=dtype)
        self.fc2 = linear(d * cfg.mlp_ratio, d, dtype=dtype)
        self.ls2 = nn.Parameter(torch.empty((d,), dtype=dtype, device="meta"),
                                requires_grad=False)

    def forward(self, x: torch.Tensor, cfg: DinoV2Config) -> torch.Tensor:
        b, s, d = x.shape
        n, hd = cfg.num_heads, cfg.head_dim
        h = layer_norm(x, cfg.eps, self.norm1.scale, self.norm1.bias)
        qkv = linear_promoted(self.qkv, h).reshape(b, s, 3, n, hd).permute(2, 0, 3, 1, 4)
        out = sdpa_bnsd(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(b, s, d)
        x = x + linear_promoted(self.out, out) * self.ls1
        h = layer_norm(x, cfg.eps, self.norm2.scale, self.norm2.bias)
        h = linear_promoted(self.fc2, F.gelu(linear_promoted(self.fc1, h)))
        return x + h * self.ls2


class DinoV2(nn.Module):
    """The JAX tree ``{"patch_embed", "cls_token", "register_tokens",
    "pos_emb", "layers"}``; built on the ``meta`` device.  ``pos_grid`` is the
    side of the square position-embedding table."""

    def __init__(self, cfg: DinoV2Config = DINOV2_BASE, pos_grid: int = DINOV2_BASE_POS_GRID,
                 dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                                requires_grad=False)

        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, dtype=dtype,
                                     device="meta")
        self.cls_token = param(1, 1, d)
        self.register_tokens = param(1, cfg.num_register_tokens, d)
        self.pos_emb = param(1, 1 + pos_grid * pos_grid, d)
        self.layers = nn.ModuleList(DinoLayer(cfg, dtype) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``dinov2_features`` of the JAX package: ImageNet-normalised pixels
        [B, H, W, 3] -> patch features [B, N, D] in the pixels' dtype, final
        LN without affine, CLS and registers dropped."""
        cfg = self.cfg
        b, h, w, _ = pixels.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        conv = self.patch_embed
        x = F.conv2d(pixels.permute(0, 3, 1, 2), conv.weight.to(pixels.dtype),
                     conv.bias.to(pixels.dtype), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(x.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = x + interpolate_pos_embed(self.pos_emb, gh, gw).to(x.dtype)
        regs = self.register_tokens.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for layer in self.layers:
            x = layer(x, cfg)
        return layer_norm(x, cfg.eps)[:, cfg.num_unused_tokens:]


@torch.no_grad()
def init_dinov2_(model: DinoV2, generator: torch.Generator) -> DinoV2:
    """Random weights of the HF distribution's scale: torch-default linears
    and patch conv, LayerNorms at (1, 0), tokens and position table
    N(0, 0.02^2), LayerScale 1.0 (HF's ``layerscale_value``)."""
    init_random_(model, generator)
    for p in (model.cls_token, model.register_tokens, model.pos_emb):
        p.normal_(0.0, 0.02, generator=generator)
    for layer in model.layers:
        layer.ls1.fill_(1.0)
        layer.ls2.fill_(1.0)
    return model
