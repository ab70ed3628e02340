"""The train-time dual visual prior (``physicedit_tpu/pipeline/visual_prior.py``).

The pseudo targets that supervise the VisualThinking dual adapter are
feature deltas between a video's middle key frames and its first (source)
frame:

- DINO branch: frames -> bicubic resize (short side 1.5 x 224) + random crop
  224 + ImageNet normalisation -> DINOv2 -> + frame-index embedding ->
  frames flattened -> Perceiver(768) -> adapter(768 -> 3584); delta against
  the same path on the source image.
- VAE branch: frames -> VAE encode -> 2 x 2 patchify (dim 64) -> + frame-index
  embedding -> flattened -> Perceiver(64) -> adapter(64 -> 3584); delta
  against the source.
"""

from __future__ import annotations

import numpy as np
import torch

from physicedit_torch.models import dinov2 as m_dino
from physicedit_torch.models import vae as m_vae
from physicedit_torch.models.adapters import visual_thinking_adapter
from physicedit_torch.ops.patchify import patchify

DINO_INPUT_SIZE = 224


def dino_preprocess(frames, rng: np.random.Generator, size: int = DINO_INPUT_SIZE) -> np.ndarray:
    """PIL frames -> [F, size, size, 3] ImageNet-normalised float32, bit for
    bit the JAX package's: PIL bicubic resize of the short side to
    1.5 * size, then a crop at offsets drawn from ``rng`` (x, then y)."""
    from PIL import Image

    first = int(size * 1.5)
    out = []
    for im in frames:
        w, h = im.size
        if w <= h:
            nw, nh = first, max(first, round(first * h / w))
        else:
            nh, nw = first, max(first, round(first * w / h))
        im = im.convert("RGB").resize((nw, nh), Image.BICUBIC)
        x0 = int(rng.integers(0, nw - size + 1))
        y0 = int(rng.integers(0, nh - size + 1))
        arr = np.asarray(im.crop((x0, y0, x0 + size, y0 + size)), np.float32) / 255.0
        out.append((arr - m_dino.IMAGENET_MEAN) / m_dino.IMAGENET_STD)
    return np.stack(out)


@torch.no_grad()
def encode_frames(vae, frames) -> torch.Tensor:
    """PIL frames of one size -> VAE latents [F, H/8, W/8, 16], one batched
    encode in the VAE's own dtype (the JAX package hands its VAE fp32 pixels
    and lets ``jnp`` promote; the port's bf16 VAE takes bf16 ones)."""
    w = next(vae.parameters())
    arr = np.stack([np.asarray(im.convert("RGB"), np.float32) / 127.5 - 1.0 for im in frames])
    return m_vae.encode(vae, torch.from_numpy(arr).to(w.device, w.dtype))


def _branch(resampler, adapter, tokens: torch.Tensor) -> torch.Tensor:
    """[1, N, dim] tokens -> [1, 64, 3584] via resampler + adapter."""
    return visual_thinking_adapter(adapter, resampler(tokens))


def compute_visual_priors(adapters, dinov2, vae, middle_key_frames, source_image,
                          rng: np.random.Generator, dtype=torch.float32):
    """(pseudo_dino, pseudo_vae), each [1, 64, 3584]: the adapter's training
    targets.  ``adapters`` holds the resamplers, their adapters and the
    frame-index embeddings (``train.trainer.TrainingAdapters``)."""
    dev = adapters.dino_time_embed.device
    f = len(middle_key_frames)

    mid = torch.from_numpy(dino_preprocess(middle_key_frames, rng)).to(dev, dtype)
    feats = dinov2(mid)
    feats = feats + adapters.dino_time_embed[:f][:, None, :].to(feats.dtype)
    mid_emb = _branch(adapters.dino_resampler, adapters.dino_resampler_adapter,
                      feats.reshape(1, -1, feats.shape[-1]))
    src = torch.from_numpy(dino_preprocess([source_image], rng)).to(dev, dtype)
    src_feats = dinov2(src)
    src_emb = _branch(adapters.dino_resampler, adapters.dino_resampler_adapter,
                      src_feats.reshape(1, -1, src_feats.shape[-1]))

    def vae_tokens(images):
        return patchify(encode_frames(vae, images).to(dtype))

    mid_lat = vae_tokens(middle_key_frames)
    mid_lat = mid_lat + adapters.vae_time_embed[:f][:, None, :].to(mid_lat.dtype)
    mid_emb_v = _branch(adapters.vae_resampler, adapters.vae_resampler_adapter,
                        mid_lat.reshape(1, -1, mid_lat.shape[-1]))
    src_lat = vae_tokens([source_image])
    src_emb_v = _branch(adapters.vae_resampler, adapters.vae_resampler_adapter,
                        src_lat.reshape(1, -1, src_lat.shape[-1]))
    return mid_emb - src_emb, mid_emb_v - src_emb_v
