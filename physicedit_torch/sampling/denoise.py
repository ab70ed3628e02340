"""The CFG flow-matching denoise loop (``physicedit_tpu/sampling/denoise.py``)
as a Python step loop.

- The CFG positive and negative rows ride the batch axis of one DiT call.
- Every step rewrites the 64 special-token embeddings with the dual
  adapter, and the rewritten embeddings feed the next step (the reference
  mutates ``prompt_emb`` in place).
- The Euler update runs in fp32; the schedule comes from
  ``sampling/flow_match.py``.
- Under ``torch.profiler`` each step is the span ``pe.denoise.step`` and
  its rewrite ``pe.denoise.adapter`` (``core/trace.py``).
- Options of ``__call__``'s other paths: an EliGen entity bias with a text
  RoPE table per CFG row, inpaint blending against the clean latents, and
  the blockwise ControlNet residual.  Under ``cfg_truncate_after`` each is
  cut to the positive rows with the prompts.
- The FLUX.1 Kontext edit (``pipeline/kontext_pipeline.py``) runs the same
  loop with one row a step (guidance distilled into the DiT, no CFG, no
  adapter), its context image as the extra tokens and its guidance and
  pooled text vector as ``dit_inputs``.
"""

from __future__ import annotations

import dataclasses

import torch

from physicedit_torch.core.trace import span
from physicedit_torch.models.adapters import dual_adapter_forward
from physicedit_torch.models.dit import DiT
from physicedit_torch.ops.patchify import patchify, unpatchify


def _rewrite_special_tokens(adapter, prompt_emb, special_idx, timestep, t_min, t_max):
    """Gather the special-token rows, run the adapter, scatter them back
    into a copy.  special_idx: [B, 64] positions into the text axis."""
    with span("pe.denoise.adapter"):
        rows = torch.arange(prompt_emb.shape[0], device=prompt_emb.device)[:, None]
        mixed, _, _ = dual_adapter_forward(adapter, prompt_emb[rows, special_idx],
                                           timestep, t_min, t_max)
        out = prompt_emb.clone()
        out[rows, special_idx] = mixed.to(prompt_emb.dtype)
        return out


def denoise(dit: DiT, latents, extra_img_tokens, prompt_emb, txt_mask,
            img_cos, img_sin, txt_cos, txt_sin, sigmas, sigmas_next, timesteps,
            cfg_scale: float, latent_hw: tuple, adapter=None, special_idx=None,
            t_min: float = 0.0, t_max: float = 1000.0, slim_last: bool = True,
            attn_clamp: bool = True, cfg_truncate_after: int | None = None,
            attn_bias_log2=None, inpaint_mask=None, input_latents=None, control=None,
            lora=None, attn_impl: str = "kernels", grad: bool = False,
            dit_inputs: dict | None = None):
    """Run the schedule; returns the final latents [N, h, w, 16].

    latents [N, h, w, 16]; extra_img_tokens [1 or N, S_extra, 64] or None;
    prompt_emb [B, S_t, D] with B = 2N under CFG (positives first);
    txt_mask [B, S_t]; txt_cos / txt_sin [S_t, 64] or, per row,
    [B, 1, S_t, 64]; sigmas / sigmas_next / timesteps [T] fp32 tensors.
    ``cfg_truncate_after = k`` runs steps [k, T) on the positive rows only
    (an opt-in serving accelerator; None keeps full CFG, the reference).
    attn_bias_log2: [B, S, S] EliGen entity bias in exp2 units.
    inpaint_mask [1, h, w, 1] in [0, 1] (1 = repaint) with input_latents
    [1, h, w, 16]: outside the mask the velocity is the one the clean
    latents imply.  control: a ``models.controlnet.Control`` (its ``step``
    is set here).  lora: live LoRA factors (``lora.DiTLoRA``).  With either,
    and under the ring, ``DiT.forward`` runs its last block full.
    attn_impl: the DiT's ("kernels", "dense" or "ring").  The loop runs
    under no-grad unless ``grad`` (``train.loss.direct_distill_loss``
    differentiates through it).  dit_inputs: further keyword inputs of every
    DiT call (``models.flux.FluxDiT``'s ``guidance`` and ``pooled``).
    """
    with torch.set_grad_enabled(grad):
        h, w = latent_hw
        n_items = latents.shape[0]
        reps = prompt_emb.shape[0] // n_items
        dtype = prompt_emb.dtype
        base = (h // 2) * (w // 2)
        k = cfg_truncate_after
        if k is not None and k < 0:
            raise ValueError(f"cfg_truncate_after must be >= 0, got {k}")

        for i in range(sigmas.shape[0]):
            with span("pe.denoise.step"):
                if k is not None and reps == 2 and i == k:
                    # late steps: positive rows only; their special tokens go on
                    # feeding the adapter
                    reps = 1
                    prompt_emb, txt_mask = prompt_emb[:n_items], txt_mask[:n_items]
                    if special_idx is not None:
                        special_idx = special_idx[:n_items]
                    if attn_bias_log2 is not None:
                        attn_bias_log2 = attn_bias_log2[:n_items]
                    if control is not None:
                        control = dataclasses.replace(control, cond=control.cond[:n_items])
                    if txt_cos.dim() == 4:
                        txt_cos, txt_sin = txt_cos[:n_items], txt_sin[:n_items]
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
                if control is not None:
                    control = dataclasses.replace(control, step=i)
                out = dit(img_tokens, prompt_emb, t_norm, img_cos, img_sin, txt_cos, txt_sin,
                          txt_key_mask=txt_mask, slim_last=base if slim_last else 0,
                          attn_clamp=attn_clamp, attn_bias_log2=attn_bias_log2,
                          control=control, lora=lora, attn_impl=attn_impl,
                          **(dit_inputs or {}))
                v = unpatchify(out[:, :base], h, w)
                if reps == 2:
                    v_posi, v_nega = v[:n_items], v[n_items:]
                    v = v_nega + cfg_scale * (v_posi - v_nega)
                if inpaint_mask is not None and input_latents is not None:
                    expected = (latents.float() - input_latents.float()) / sigma
                    v = expected * (1.0 - inpaint_mask) + v.float() * inpaint_mask
                latents = (latents.float() + v.float() * (sigma_next - sigma)).to(latents.dtype)
        return latents
