"""The FLUX.1 Kontext [dev] edit on PyTorch: the denoise of diffusers'
``FluxKontextPipeline`` over the port's FLUX DiT (``models/flux.py``).

The pipeline takes what FLUX's text encoders and VAE give: the T5-XXL rows
``[B, 512, 4096]`` (every row attended, as diffusers pads them), the pooled
CLIP-L vector ``[B, 768]`` and the context image's packed latents ``[1,
S_c, 64]``.  The encoders and the VAE are not in the port; they run once an
edit, outside the denoise.  Each step is one DiT row: the target's latent
tokens, then the context image's, under FLUX's position ids
(``ops.rope.flux_rope_tables``: target (0, i, j), context (1, i, j), text
0), with the guidance scale embedded in the DiT (no CFG) and the last
single-stream block slim.  The schedule is ``sampling.flow_match.flux_schedule``;
the loop is ``sampling.denoise.denoise``, the Qwen-Image edit's.

As in ``pipeline/edit_pipeline.py``, :meth:`FluxKontextPipeline._run_denoise`
is the timed denoise: its time in ``self.timings["denoise"]`` (ms, after a
device synchronise), and under ``torch.profiler`` the span ``pe.stage.denoise``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from physicedit_torch.core.trace import span
from physicedit_torch.models.dit import attn_clamp_needed
from physicedit_torch.models.flux import FluxDiT
from physicedit_torch.ops import rope as m_rope
from physicedit_torch.sampling import flow_match as fm
from physicedit_torch.sampling.denoise import denoise

GUIDANCE = 2.5      # FluxKontextPipeline's default guidance_scale
STEPS = 28          # and num_inference_steps


class FluxKontextPipeline:
    def __init__(self, dit: FluxDiT, dtype=torch.bfloat16, device="cuda"):
        self.dit = dit
        self.dtype = dtype
        self.device = torch.device(device)
        # load-time decision (models/dit.attn_clamp_needed)
        self.attn_clamp = attn_clamp_needed(dit)
        self.timings: dict = {}

    @contextlib.contextmanager
    def _timed(self, name: str):
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        with span(f"pe.stage.{name}"):
            yield
        sync()
        self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def _tensor(self, arr, dtype=None):
        return torch.as_tensor(np.asarray(arr), device=self.device).to(dtype or self.dtype)

    @torch.no_grad()
    def __call__(self, latents, prompt_emb, pooled, context_tokens, context_hw: tuple,
                 guidance: float = GUIDANCE, num_inference_steps: int = STEPS):
        """The edit's final latents [1, h, w, 16] from the starting noise
        ``latents`` [1, h, w, 16] (h, w: the output's height and width / 8).

        prompt_emb [1, S_t, 4096] (T5 rows); pooled [1, 768]; context_tokens
        [1, S_c, 64], the context image's latents packed on a ``context_hw``
        (rows, columns) grid of 2 x 2 patches."""
        lat_h, lat_w = latents.shape[1:3]
        sched = fm.flux_schedule(num_inference_steps, (lat_h // 2) * (lat_w // 2))
        ropes = m_rope.flux_rope_tables([(1, lat_h // 2, lat_w // 2), (1, *context_hw)],
                                        prompt_emb.shape[1])
        return self._run_denoise(latents, context_tokens, prompt_emb, pooled, guidance, ropes,
                                 sched, (lat_h, lat_w))

    def _run_denoise(self, latents, context_tokens, prompt_emb, pooled, guidance: float, ropes,
                     sched, latent_hw):
        """The timed denoise: the tables and the schedule to the device, then
        ``denoise`` with one row a step and the guidance and pooled vector
        fed to the DiT."""
        with self._timed("denoise"):
            rows = prompt_emb.shape[0]
            dit_inputs = {"guidance": torch.full((rows,), float(guidance), device=self.device,
                                                 dtype=self.dtype),
                          "pooled": pooled.to(self.device, self.dtype)}
            return denoise(
                self.dit, latents, context_tokens, prompt_emb.to(self.device, self.dtype), None,
                *(self._tensor(r, torch.float32) for r in ropes),
                self._tensor(sched.sigmas, torch.float32),
                self._tensor(sched.sigmas_next, torch.float32),
                self._tensor(sched.timesteps, torch.float32), 1.0,
                latent_hw=latent_hw, attn_clamp=self.attn_clamp, dit_inputs=dit_inputs)
