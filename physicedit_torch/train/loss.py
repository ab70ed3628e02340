"""The PhysicEdit training loss (``physicedit_tpu/train/loss.py``):
flow-matching MSE plus the special-token (dual adapter) loss.

Two load-bearing reference semantics, as in the JAX package:
- the pseudo targets (DINO / VAE feature deltas) are computed inside the
  differentiated forward through the trainable resamplers, so the adapter
  MSE pulls on both its heads and the resampler branches;
- the special-token rewrite happens before the DiT forward, so the DiT's
  flow loss backpropagates into the dual adapter as well.

The DiT runs in the dtype of ``batch["prompt_emb"]``; the trainer hands it
the pipeline's dtype (bf16 at full width, where K1 and K8 take it).
"""

from __future__ import annotations

import torch

from physicedit_torch.models.adapters import (dual_adapter_forward, dual_adapter_loss,
                                              visual_thinking_adapter)
from physicedit_torch.ops.patchify import patchify, unpatchify


def _prior_branch(resampler, adapter, time_embed, feats, frame_mask=None):
    """feats [B, F, N, dim] -> [B, 64, 3584]: frame-index embedding added per
    frame, frames flattened into one media sequence, Perceiver + projector.
    frame_mask [B, F] bool leaves zero-padded frames out of the keys."""
    b, f, n, d = feats.shape
    if time_embed is not None:
        feats = feats + time_embed[:f][None, :, None, :].to(feats.dtype)
    tokens = feats.reshape(b, f * n, d)
    media_mask = None if frame_mask is None else frame_mask.repeat_interleave(n, dim=1)
    return visual_thinking_adapter(adapter, resampler(tokens, media_mask=media_mask))


def compute_pseudo_targets(adapters, batch: dict):
    """(gt_dino, gt_vae), each [B, 64, 3584], from the frozen backbones' raw
    features in the batch: dino_mid_feats [B, F, N, 768], dino_src_feats
    [B, 1, N, 768], vae_mid_tokens [B, F, S, 64], vae_src_tokens [B, 1, S, 64]
    and the optional mid_frame_mask [B, F]."""
    fmask = batch.get("mid_frame_mask")
    gt_dino = (
        _prior_branch(adapters.dino_resampler, adapters.dino_resampler_adapter,
                      adapters.dino_time_embed, batch["dino_mid_feats"], fmask)
        - _prior_branch(adapters.dino_resampler, adapters.dino_resampler_adapter,
                        None, batch["dino_src_feats"]))
    gt_vae = (
        _prior_branch(adapters.vae_resampler, adapters.vae_resampler_adapter,
                      adapters.vae_time_embed, batch["vae_mid_tokens"], fmask)
        - _prior_branch(adapters.vae_resampler, adapters.vae_resampler_adapter,
                        None, batch["vae_src_tokens"]))
    return gt_dino, gt_vae


def physic_training_loss(trainable, dit, batch: dict, t_min: float, t_max: float,
                         use_remat: bool = False):
    """(loss, metrics) for one batch.

    trainable: ``train.trainer.Trainable`` (``lora`` over the frozen DiT and
    the training ``adapters``); dit: the frozen DiT (bf16 or packed int4).
    batch: input_latents / noise [B, h, w, 16], sigma / timestep / weight [B],
    edit_tokens [B, S_e, 64] or None, prompt_emb [B, S_t, 3584], txt_mask
    [B, S_t], special_idx [B, 64], the prior features, the RoPE tables.
    """
    adapters = trainable.adapters
    x0 = batch["input_latents"]
    noise = batch["noise"]
    sigma = batch["sigma"][:, None, None, None]
    latents = (1.0 - sigma) * x0 + sigma * noise
    target = noise - x0

    gt_dino, gt_vae = compute_pseudo_targets(adapters, batch)

    prompt_emb = batch["prompt_emb"]
    idx = batch["special_idx"].long()[:, :, None].expand(-1, -1, prompt_emb.shape[-1])
    special = torch.gather(prompt_emb, 1, idx)
    mixed, pred_dino, pred_vae = dual_adapter_forward(
        adapters.visual_thinking_adapter, special, batch["timestep"], t_min, t_max)
    prompt_emb = prompt_emb.scatter(1, idx, mixed.to(prompt_emb.dtype))

    img_tokens = patchify(latents.to(prompt_emb.dtype))
    h, w = x0.shape[1], x0.shape[2]
    s_base = img_tokens.shape[1]
    if batch.get("edit_tokens") is not None:
        img_tokens = torch.cat([img_tokens, batch["edit_tokens"].to(prompt_emb.dtype)], dim=1)

    v = dit(img_tokens, prompt_emb, (batch["timestep"] / 1000.0).to(prompt_emb.dtype),
            batch["img_cos"], batch["img_sin"], batch["txt_cos"], batch["txt_sin"],
            txt_key_mask=batch["txt_mask"], lora=trainable.lora, use_remat=use_remat)
    v = unpatchify(v[:, :s_base], h, w)

    # each sample's bell weight scales its own mean-square error
    sq = (v.float() - target.float()).square()
    per_sample = sq.reshape(sq.shape[0], -1).mean(1)
    mse = per_sample.mean()
    adapter = dual_adapter_loss(pred_dino, pred_vae, gt_dino, gt_vae, batch["timestep"],
                                t_min, t_max)
    loss = (per_sample * batch["weight"].float()).mean() + adapter
    return loss, {"mse": mse.detach(), "special_token_loss": adapter.detach()}
