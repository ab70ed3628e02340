"""FLUX.1 Kontext [dev] in plain PyTorch, fp32: the test suite's reference
for ``physicedit_torch``'s FLUX DiT, schedule and Kontext denoise.  It
imports nothing of ``physicedit_torch`` and no JAX.

Written from diffusers' ``FluxTransformer2DModel``
(``models/transformers/transformer_flux.py``) and ``FluxKontextPipeline``,
with the weights in diffusers' key space (``transformer_blocks.{i}.attn.to_q``,
``single_transformer_blocks.{i}.proj_mlp``, ``time_text_embed.*``,
``norm_out.linear`` with its scale half first):

- ``Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0)`` of
  ``1000 t`` and of ``1000 g``, each through its ``TimestepEmbedding``
  (linear, SiLU, linear), plus ``text_embedder(pooled)``: the conditioning
  ``temb``; every ``AdaLayerNorm*`` reads ``silu(temb)``.
- ``FluxTransformerBlock``: ``AdaLayerNormZero`` (shift, scale, gate of the
  attention, then of the MLP) on each stream, separate q / k / v
  projections, ``RMSNorm`` of q and k per head, the text's rows first in
  one attention, ``apply_rotary_emb`` (cos and sin repeated per pair, the
  rotated copy ``(-x1, x0)``), ``to_out.0`` / ``to_add_out``, then
  ``FeedForward(activation_fn="gelu-tanh")``.
- ``FluxSingleTransformerBlock``: ``AdaLayerNormZeroSingle`` (shift,
  scale, gate) over ``cat(txt, img)``, ``proj_mlp`` + tanh GELU beside the
  attention, ``proj_out(cat(attn, mlp))`` gated onto the residual.
- ``FluxPosEmbed``: ids (0, 0, 0) for the text, (0, i, j) for the target
  and (1, i, j) for the context image (Kontext's ``image_ids[..., 0] = 1``).
- The schedule of ``FlowMatchEulerDiscreteScheduler`` with dynamic
  shifting (sigmas ``linspace(1, 1/N, N)`` in float32, ``mu`` from 256 /
  4096 tokens at 0.5 / 1.15), and its Euler step.

Departures: none in the arithmetic, which is fp32 throughout (diffusers
runs the model in the weights' dtype); the attention is an explicit fp32
softmax.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-6
THETA = 10000.0
AXES = (16, 56, 56)


def linear(sd, prefix, x):
    y = x @ sd[f"{prefix}.weight"].float().T
    b = sd.get(f"{prefix}.bias")
    return y if b is None else y + b.float()


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def rms_norm(x, weight):
    return x / torch.sqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * weight.float()


def timesteps_proj(t, dim=256):
    """diffusers' ``get_timestep_embedding`` with ``flip_sin_to_cos``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def pack(latents):
    """[B, C, H, W] -> [B, H/2 * W/2, 4C] (``_pack_latents``)."""
    b, c, h, w = latents.shape
    x = latents.view(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def image_ids(h: int, w: int, first: int = 0):
    """[h * w, 3] ids of a grid of h x w packed tokens (``_prepare_latent_image_ids``)."""
    ids = torch.zeros(h, w, 3)
    ids[..., 0] = first
    ids[..., 1] = torch.arange(h)[:, None]
    ids[..., 2] = torch.arange(w)[None, :]
    return ids.reshape(h * w, 3)


def pos_embed(ids):
    """(cos, sin), [S, 128] each, repeated per pair (``FluxPosEmbed``)."""
    cos, sin = [], []
    for a, d in enumerate(AXES):
        freqs = 1.0 / THETA ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
        ang = torch.outer(ids[:, a].double(), freqs)
        cos.append(ang.cos().repeat_interleave(2, dim=1))
        sin.append(ang.sin().repeat_interleave(2, dim=1))
    return torch.cat(cos, -1).float(), torch.cat(sin, -1).float()


def apply_rotary_emb(x, cos, sin):
    """x [B, S, H, D]; cos / sin [S, D]."""
    x_real, x_imag = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    rotated = torch.stack([-x_imag, x_real], dim=-1).flatten(3)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


def attention(q, k, v):
    """q [B, Sq, H, D], k / v [B, Sk, H, D] -> [B, Sq, H * D]."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    out = (p @ v).transpose(1, 2)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _heads(x, n):
    return x.unflatten(-1, (n, -1))


def double_block(sd, p, hidden, context, temb, cos, sin, n):
    s_t = context.shape[1]
    sh, sc, g, sh2, sc2, g2 = linear(sd, f"{p}.norm1.linear", silu(temb)).chunk(6, -1)
    csh, csc, cg, csh2, csc2, cg2 = linear(sd, f"{p}.norm1_context.linear", silu(temb)).chunk(6, -1)
    nh = layer_norm(hidden) * (1 + sc[:, None]) + sh[:, None]
    nc = layer_norm(context) * (1 + csc[:, None]) + csh[:, None]
    a = f"{p}.attn"
    q = rms_norm(_heads(linear(sd, f"{a}.to_q", nh), n), sd[f"{a}.norm_q.weight"])
    k = rms_norm(_heads(linear(sd, f"{a}.to_k", nh), n), sd[f"{a}.norm_k.weight"])
    v = _heads(linear(sd, f"{a}.to_v", nh), n)
    cq = rms_norm(_heads(linear(sd, f"{a}.add_q_proj", nc), n), sd[f"{a}.norm_added_q.weight"])
    ck = rms_norm(_heads(linear(sd, f"{a}.add_k_proj", nc), n), sd[f"{a}.norm_added_k.weight"])
    cv = _heads(linear(sd, f"{a}.add_v_proj", nc), n)
    q = apply_rotary_emb(torch.cat([cq, q], 1), cos, sin)
    k = apply_rotary_emb(torch.cat([ck, k], 1), cos, sin)
    out = attention(q, k, torch.cat([cv, v], 1))
    hidden = hidden + g[:, None] * linear(sd, f"{a}.to_out.0", out[:, s_t:])
    context = context + cg[:, None] * linear(sd, f"{a}.to_add_out", out[:, :s_t])

    def ff(prefix, x):
        return linear(sd, f"{prefix}.net.2", gelu_tanh(linear(sd, f"{prefix}.net.0.proj", x)))

    hidden = hidden + g2[:, None] * ff(f"{p}.ff", layer_norm(hidden) * (1 + sc2[:, None])
                                       + sh2[:, None])
    context = context + cg2[:, None] * ff(f"{p}.ff_context", layer_norm(context)
                                          * (1 + csc2[:, None]) + csh2[:, None])
    return context, hidden


def single_block(sd, p, x, temb, cos, sin, n):
    sh, sc, g = linear(sd, f"{p}.norm.linear", silu(temb)).chunk(3, -1)
    h = layer_norm(x) * (1 + sc[:, None]) + sh[:, None]
    mlp = gelu_tanh(linear(sd, f"{p}.proj_mlp", h))
    a = f"{p}.attn"
    q = apply_rotary_emb(rms_norm(_heads(linear(sd, f"{a}.to_q", h), n), sd[f"{a}.norm_q.weight"]),
                         cos, sin)
    k = apply_rotary_emb(rms_norm(_heads(linear(sd, f"{a}.to_k", h), n), sd[f"{a}.norm_k.weight"]),
                         cos, sin)
    out = attention(q, k, _heads(linear(sd, f"{a}.to_v", h), n))
    return x + g[:, None] * linear(sd, f"{p}.proj_out", torch.cat([out, mlp], dim=2))


def _count(sd, prefix):
    return 1 + max(int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix))


@torch.no_grad()
def transformer(sd, hidden_states, encoder_hidden_states, timestep, guidance, pooled,
                txt_ids, img_ids, num_heads: int):
    """``FluxTransformer2DModel.forward``: [B, S_i, 64] for every image row.
    timestep [B] in [0, 1] (the pipeline's ``t / 1000``); guidance [B]."""
    hidden = linear(sd, "x_embedder", hidden_states.float())
    temb = (linear(sd, "time_text_embed.timestep_embedder.linear_2", silu(linear(
                sd, "time_text_embed.timestep_embedder.linear_1",
                timesteps_proj(timestep.float() * 1000))))
            + linear(sd, "time_text_embed.guidance_embedder.linear_2", silu(linear(
                sd, "time_text_embed.guidance_embedder.linear_1",
                timesteps_proj(guidance.float() * 1000))))
            + linear(sd, "time_text_embed.text_embedder.linear_2", silu(linear(
                sd, "time_text_embed.text_embedder.linear_1", pooled.float()))))
    context = linear(sd, "context_embedder", encoder_hidden_states.float())
    cos, sin = pos_embed(torch.cat([txt_ids, img_ids]))
    for i in range(_count(sd, "transformer_blocks.")):
        context, hidden = double_block(sd, f"transformer_blocks.{i}", hidden, context, temb,
                                       cos, sin, num_heads)
    s_t = context.shape[1]
    x = torch.cat([context, hidden], dim=1)
    for i in range(_count(sd, "single_transformer_blocks.")):
        x = single_block(sd, f"single_transformer_blocks.{i}", x, temb, cos, sin, num_heads)
    scale, shift = linear(sd, "norm_out.linear", silu(temb)).chunk(2, -1)
    x = layer_norm(x[:, s_t:]) * (1 + scale[:, None]) + shift[:, None]
    return linear(sd, "proj_out", x)


def schedule(steps: int, image_seq_len: int):
    """(sigmas [steps + 1] with the terminal 0, timesteps [steps]), float32."""
    sigmas = np.linspace(1.0, 1.0 / steps, steps).astype(np.float32)
    m = (1.15 - 0.5) / (4096 - 256)
    mu = image_seq_len * m + (0.5 - m * 256)
    sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    sigmas = torch.from_numpy(np.asarray(sigmas, np.float32))
    return torch.cat([sigmas, torch.zeros(1)]), sigmas * 1000


@torch.no_grad()
def kontext_denoise(sd, latents, grid: tuple, context_latents, context_grid: tuple,
                    prompt_embeds, pooled, guidance: float, steps: int, num_heads: int):
    """The Kontext loop on packed tokens: latents [1, S, 64] (the target's
    noise) on a ``grid`` of (rows, columns), context_latents [1, S_c, 64] on
    ``context_grid``; returns the final packed latents, fp32."""
    (h, w), (hc, wc) = grid, context_grid
    img_ids = torch.cat([image_ids(h, w), image_ids(hc, wc, first=1)])
    txt_ids = torch.zeros(prompt_embeds.shape[1], 3)
    sigmas, timesteps = schedule(steps, latents.shape[1])
    g = torch.full((latents.shape[0],), float(guidance))
    x = latents.float()
    for i in range(steps):
        v = transformer(sd, torch.cat([x, context_latents.float()], dim=1), prompt_embeds,
                        (timesteps[i] / 1000).expand(x.shape[0]), g, pooled, txt_ids, img_ids,
                        num_heads)[:, :x.shape[1]]
        x = x + (sigmas[i + 1] - sigmas[i]) * v
    return x
