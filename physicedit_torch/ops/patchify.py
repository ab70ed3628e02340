"""Latent patchify / unpatchify over NHWC latents (2x2 pixel shuffle of the
16-channel VAE latent), as ``physicedit_tpu/ops/patchify.py``."""

from __future__ import annotations

import torch


def patchify(latents_nhwc: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2 * W/2, C * 4]; feature index c*4 + p*2 + q."""
    b, h, w, c = latents_nhwc.shape
    x = latents_nhwc.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpatchify(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, S, C * 4] -> [B, height, width, C] (latent-space sizes)."""
    b, _, d = tokens.shape
    x = tokens.reshape(b, height // 2, width // 2, d // 4, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, height, width, d // 4)
