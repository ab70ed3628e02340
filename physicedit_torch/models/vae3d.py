"""Qwen-Image (Wan-style) VAE, video mode: causal 3D convolutions over T
(``physicedit_tpu/models/vae3d.py``).

The reference QwenImageVAE accepts 5D video input
(qwen_image_vae.py:706-729).  Its temporal down / up sampling
(``time_conv`` inside QwenImageResample) runs only when a streaming feature
cache is supplied (qwen_image_vae.py:259-300), and ``encode`` / ``decode``
never supply one: the video path is causal 3D convolutions over the whole
clip, per-frame spatial resampling and no temporal compression.  The
``time_conv`` weights of a published file are read by nothing.

The network is the image VAE's (``models/vae.py``) with its residual,
``conv_in`` and ``conv_out`` convolutions as :class:`CausalConv3d` (``kt -
1`` zero frames in front of time, spatial SAME); attention, down and up
sampling and the 1x1 quant convs run per frame with T folded into the
batch (``vae.per_frame``).

Layout: the public functions take and return NTHWC.  Inside, the
activations are ``[B, C, T, H, W]`` in channels-last-3d memory (the NTHWC
input permuted, no copy), so folding T into the batch for a per-frame op
is a view, and the output's permute back to NTHWC is one too.  The copies
left are each causal conv's front pad and the attention's q / k / v split.
"""

from __future__ import annotations

import torch

from physicedit_torch.models.vae import (QWEN_VAE_CONFIG, VAE, VAEConfig, _stats,
                                         decoder_forward, encoder_forward, per_frame)

__all__ = ["VideoVAE", "encode", "decode", "QWEN_VAE_CONFIG", "VAEConfig"]


class VideoVAE(VAE):
    """The video-mode VAE: the image VAE's tree with 3-tap causal convs."""

    temporal_taps = 3


@torch.no_grad()
def encode(vae: VideoVAE, x: torch.Tensor) -> torch.Tensor:
    """Video [B, T, H, W, 3] in [-1, 1] -> latents [B, T, H/8, W/8, 16]."""
    z = encoder_forward(vae.encoder, x.permute(0, 4, 1, 2, 3))
    z = per_frame(vae.quant_conv, z)[:, :vae.cfg.z_dim].permute(0, 2, 3, 4, 1)
    mean, std = _stats(z)
    return (z - mean) / std


@torch.no_grad()
def decode(vae: VideoVAE, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, T, h, w, 16] -> video [B, T, 8h, 8w, 3] (about [-1, 1])."""
    mean, std = _stats(z)
    z = (z * std + mean).permute(0, 4, 1, 2, 3)
    video = decoder_forward(vae.decoder, per_frame(vae.post_quant_conv, z))
    return video.permute(0, 2, 3, 4, 1)
