"""The VisualThinking dual adapter (``physicedit_tpu/models/adapters.py``):
at every denoise step it rewrites the 64 special-token embeddings as the
timestep-mixed alpha(t) * head_dino(x) + (1 - alpha) * head_vae(x).

Only the inference forward is ported; the training loss and the
PerceiverResampler belong to training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import linear

SPECIAL_TOKEN_NUM = 64


def _head(in_dim: int, out_dim: int, dtype) -> nn.ModuleDict:
    """Linear(out * 3) -> exact GELU -> Linear."""
    return nn.ModuleDict({"fc1": linear(in_dim, out_dim * 3, dtype=dtype),
                          "fc2": linear(out_dim * 3, out_dim, dtype=dtype)})


def visual_thinking_adapter(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    return p["fc2"](F.gelu(p["fc1"](x)))


class DualAdapter(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, in_dim: int = 3584, out_dim: int = 3584, dtype=None):
        super().__init__()
        self.head_dino = _head(in_dim, out_dim, dtype)
        self.head_vae = _head(in_dim, out_dim, dtype)


def dual_adapter_alpha(timestep: torch.Tensor, t_min: float, t_max: float):
    """alpha(t) = clip((t - t_min) / (t_max - t_min + 1e-6), 0, 1), fp32."""
    return ((timestep.float() - t_min) / (t_max - t_min + 1e-6)).clamp(0.0, 1.0)


def dual_adapter_forward(adapter: DualAdapter, x: torch.Tensor,
                         timestep: torch.Tensor, t_min: float, t_max: float):
    """Returns (mixed, pred_dino, pred_vae).  x: [B, S, D]; timestep: [B] in
    training-timestep units (0..1000)."""
    pred_dino = visual_thinking_adapter(adapter.head_dino, x)
    pred_vae = visual_thinking_adapter(adapter.head_vae, x)
    alpha = dual_adapter_alpha(timestep, t_min, t_max)[:, None, None].to(pred_dino.dtype)
    return alpha * pred_dino + (1 - alpha) * pred_vae, pred_dino, pred_vae
