"""The CFG flow-matching denoise loop (``physicedit_tpu/sampling/denoise.py``)
as a Python step loop.

- The CFG positive and negative rows ride the batch axis of one DiT call.
- Every step rewrites the 64 special-token embeddings with the dual
  adapter, and the rewritten embeddings feed the next step (the reference
  mutates ``prompt_emb`` in place).
- The Euler update runs in fp32; the schedule comes from
  ``physicedit_tpu.sampling.flow_match``.
"""

from __future__ import annotations

import torch

from physicedit_torch.models.adapters import dual_adapter_forward
from physicedit_torch.models.dit import DiT
from physicedit_torch.ops.patchify import patchify, unpatchify


def _rewrite_special_tokens(adapter, prompt_emb, special_idx, timestep, t_min, t_max):
    """Gather the special-token rows, run the adapter, scatter them back
    into a copy.  special_idx: [B, 64] positions into the text axis."""
    rows = torch.arange(prompt_emb.shape[0], device=prompt_emb.device)[:, None]
    mixed, _, _ = dual_adapter_forward(adapter, prompt_emb[rows, special_idx],
                                       timestep, t_min, t_max)
    out = prompt_emb.clone()
    out[rows, special_idx] = mixed.to(prompt_emb.dtype)
    return out


@torch.no_grad()
def denoise(dit: DiT, latents, extra_img_tokens, prompt_emb, txt_mask,
            img_cos, img_sin, txt_cos, txt_sin, sigmas, sigmas_next, timesteps,
            cfg_scale: float, latent_hw: tuple, adapter=None, special_idx=None,
            t_min: float = 0.0, t_max: float = 1000.0, slim_last: bool = True,
            attn_clamp: bool = True, cfg_truncate_after: int | None = None):
    """Run the schedule; returns the final latents [N, h, w, 16].

    latents [N, h, w, 16]; extra_img_tokens [1, S_extra, 64] or None;
    prompt_emb [B, S_t, D] with B = 2N under CFG (positives first);
    txt_mask [B, S_t]; sigmas / sigmas_next / timesteps [T] fp32 tensors.
    ``cfg_truncate_after = k`` runs steps [k, T) on the positive rows only
    (an opt-in serving accelerator; None keeps full CFG, the reference).
    """
    h, w = latent_hw
    n_items = latents.shape[0]
    reps = prompt_emb.shape[0] // n_items
    dtype = prompt_emb.dtype
    base = (h // 2) * (w // 2)
    k = cfg_truncate_after
    if k is not None and k < 0:
        raise ValueError(f"cfg_truncate_after must be >= 0, got {k}")

    for i in range(sigmas.shape[0]):
        if k is not None and reps == 2 and i == k:
            # late steps: positive rows only; their special tokens go on
            # feeding the adapter
            reps = 1
            prompt_emb, txt_mask = prompt_emb[:n_items], txt_mask[:n_items]
            if special_idx is not None:
                special_idx = special_idx[:n_items]
        sigma, sigma_next, timestep = sigmas[i], sigmas_next[i], timesteps[i]
        batch = prompt_emb.shape[0]
        if adapter is not None and special_idx is not None:
            prompt_emb = _rewrite_special_tokens(
                adapter, prompt_emb, special_idx, timestep.expand(batch), t_min, t_max)

        img_tokens = patchify(latents.to(dtype))
        if extra_img_tokens is not None:
            extra = extra_img_tokens.to(dtype).expand(n_items, -1, -1)
            img_tokens = torch.cat([img_tokens, extra], dim=1)
        if reps > 1:
            img_tokens = img_tokens.repeat(reps, 1, 1)
        t_norm = (timestep / 1000.0).expand(batch).to(dtype)
        out = dit(img_tokens, prompt_emb, t_norm, img_cos, img_sin, txt_cos, txt_sin,
                  txt_key_mask=txt_mask, slim_last=base if slim_last else 0,
                  attn_clamp=attn_clamp)
        v = unpatchify(out[:, :base], h, w)
        if reps == 2:
            v_posi, v_nega = v[:n_items], v[n_items:]
            v = v_nega + cfg_scale * (v_posi - v_nega)
        latents = (latents.float() + v.float() * (sigma_next - sigma)).to(latents.dtype)
    return latents
