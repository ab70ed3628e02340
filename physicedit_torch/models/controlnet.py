"""Blockwise ControlNet for the Qwen-Image DiT
(``physicedit_tpu/models/controlnet.py``) as ``nn.Module``s.

``img_in`` (64 patch channels, plus any extra inpaint channels, -> dim)
turns the conditioning latents into tokens once per edit; then one
``RMSNorm(x) + RMSNorm(y) -> Linear -> GELU -> Linear`` block per DiT block
adds a residual to the base image rows after that block, gated by a
per-step scale (``controlnet_step_scales``).  The blocks sit in an
``nn.ModuleList`` beside the DiT's, one per layer.  :class:`Control` carries
the net, its processed conditioning and the gates through one edit's denoise
into the DiT.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.ops.norms import rms_norm


class ControlBlock(nn.Module):
    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.x_rms = Leaf(scale=(dim,), dtype=dtype)
        self.y_rms = Leaf(scale=(dim,), dtype=dtype)
        self.input_proj = linear(dim, dim, dtype=dtype)
        self.output_proj = linear(dim, dim, dtype=dtype)


class BlockwiseControlNet(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, num_layers: int = 60, in_dim: int = 64, additional_in_dim: int = 0,
                 dim: int = 3072, dtype=None):
        super().__init__()
        self.img_in = linear(in_dim + additional_in_dim, dim, dtype=dtype)
        self.blocks = nn.ModuleList(ControlBlock(dim, dtype) for _ in range(num_layers))


def control_block(p: ControlBlock, x: torch.Tensor, y: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The residual of one block.  x: image tokens [B, S, dim]; y: the
    processed conditioning [B, S, dim]."""
    h = rms_norm(x, p.x_rms.scale, eps) + rms_norm(y, p.y_rms.scale, eps)
    return p.output_proj(F.gelu(p.input_proj(h), approximate="none"))


@dataclasses.dataclass(frozen=True)
class Control:
    """A blockwise ControlNet as one edit applies it: ``net``, the processed
    conditioning ``cond`` [B, S_base, dim] (one row per CFG row), the
    per-step gates ``scales`` [T] and the denoise ``step`` being run."""
    net: BlockwiseControlNet
    cond: torch.Tensor
    scales: torch.Tensor
    step: int = 0

    def add_residual(self, layer: int, image: torch.Tensor) -> torch.Tensor:
        """DiT block ``layer``'s output image stream with this block's gated
        residual added to the base image rows (the first S_base)."""
        s = self.cond.shape[1]
        res = control_block(self.net.blocks[layer], image[:, :s], self.cond)
        upd = (res.float() * self.scales[self.step]).to(image.dtype)
        return torch.cat([image[:, :s] + upd, image[:, s:]], dim=1)


def process_conditioning(cn: BlockwiseControlNet, cond_tokens: torch.Tensor) -> torch.Tensor:
    """Patchified conditioning latents [B, S, 64 (+ extra)] -> [B, S, dim]."""
    return cn.img_in(cond_tokens)


def controlnet_step_scales(num_inference_steps: int, start: float = 1.0, end: float = 0.0,
                           scale: float = 1.0) -> np.ndarray:
    """Per-step gate: ``scale`` where progress = (T-1-i)/(T-1) lies in
    [end, start], else 0 (fp32 [T])."""
    t = num_inference_steps
    progress = (t - 1 - np.arange(t)) / max(t - 1, 1)
    active = (progress <= start + 1e-4) & (progress >= end - 1e-4)
    return np.where(active, scale, 0.0).astype(np.float32)
