"""FLUX.1 Kontext [dev]: the DiT forward, the schedule, the position tables
and the Euler step in plain PyTorch (fp32, TF32 off) and NumPy, one block
at a time.

Written from diffusers' ``FluxTransformer2DModel`` and
``FluxKontextPipeline``:

- ``vec = timestep_embedder(emb(1000 t)) + guidance_embedder(emb(1000 g))
  + text_embedder(pooled)``, each a two-layer MLP with SiLU between; every
  modulation reads ``silu(vec)``.
- 19 double-stream blocks: per stream ``shift, scale, gate`` twice
  (``norm1.linear`` / ``norm1_context.linear``), the modulated LayerNorm
  (no affine, eps 1e-6), q, k, v with bias, per-head RMSNorm of q and k,
  RoPE, one softmax attention over the text then the image, the gated
  output projections, then the gated tanh-GELU MLPs.
- 38 single-stream blocks over ``x = cat(txt, img)``: ``shift, scale,
  gate``; ``h = LN(x) (1 + scale) + shift``; q, k, v of ``h`` with one gain
  pair and RoPE over the joint sequence; ``m = gelu_tanh(proj_mlp(h))``;
  ``x = x + gate proj_out(cat(attn, m))``.
- The final layer: ``scale, shift`` (in that order) from
  ``norm_out.linear``, the LayerNorm, ``proj_out``.
- RoPE (``FluxPosEmbed``, theta 10,000, axes 16 / 56 / 56): per axis the
  angles ``id * theta^(-2i/d)``, rotating adjacent pairs; text ids are 0,
  the target's (0, i, j), the context image's (1, i, j).
- The schedule: sigmas ``linspace(1, 1/N, N)``, exponentially shifted by
  ``mu`` (0.5 at 256 target tokens to 1.15 at 4,096); timesteps ``1000
  sigma``; the Euler step ``x + v (sigma_next - sigma)``, 0 past the end.

Only the output image's rows reach the output, so the last single-stream
block is queried by them alone.  Weights come from ``weights(group)``,
named as the port's state dict (``blocks.3.attn.img_qkv.weight``: diffusers'
``to_q``, ``to_k``, ``to_v`` stacked; ``single_blocks.7.proj_out.weight``),
drawn again per group, so only one block is held in fp32 at a time.

Departures from diffusers: the timestep and the guidance are embedded as
the bf16 deployment hands them over (``t / 1000`` rounded to bf16, the
frequency table rounded through bf16; diffusers rounds ``1000 t`` to bf16
and keeps the table in fp32), the schedule is worked out in float64
(diffusers shifts float32 sigmas), and the attention is computed head chunk
by head chunk so that the fp32 scores fit beside the weights.  None in the
arithmetic otherwise.  Every linear, and the bf16 states between
operations, go through ``arith`` (``pebench/reference/arith.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pebench.reference.arith import Arith
from pebench.reference.dit import _lin, attention, layer_norm, rms_norm, rope

THETA = 10000.0


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def timestep_embedding(t: torch.Tensor, dim: int, table_dtype=torch.bfloat16) -> torch.Tensor:
    """cos then sin of ``1000 t`` times the frequency table, the table
    rounded through ``table_dtype`` (the deployment's dtype) first."""
    half = dim // 2
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(t.device).to(table_dtype).float()
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _angles(ids: np.ndarray, axes: tuple) -> np.ndarray:
    out = []
    for a, d in enumerate(axes):
        inv = 1.0 / (THETA ** (np.arange(0, d, 2, dtype=np.float64) / d))
        out.append(np.outer(ids[:, a].astype(np.float64), inv))
    return np.concatenate(out, axis=1)


def tables(img_shapes: list, txt_len: int, axes: tuple = (16, 56, 56)):
    """(img_cos, img_sin, txt_cos, txt_sin), float32 [S, sum(axes) / 2]:
    image ``i`` of ``[(1, h, w), ...]`` takes the ids (i, row, column)."""
    ids = []
    for i, (_, h, w) in enumerate(img_shapes):
        grid = np.zeros((h, w, 3))
        grid[..., 0] = i
        grid[..., 1] = np.arange(h)[:, None]
        grid[..., 2] = np.arange(w)[None, :]
        ids.append(grid.reshape(-1, 3))
    img = _angles(np.concatenate(ids), axes)
    txt = _angles(np.zeros((txt_len, 3)), axes)
    return (np.cos(img).astype(np.float32), np.sin(img).astype(np.float32),
            np.cos(txt).astype(np.float32), np.sin(txt).astype(np.float32))


def schedule(steps: int, image_seq_len: int):
    """(sigmas, sigmas_next, timesteps), float32 [steps]."""
    sigmas = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    m = (1.15 - 0.5) / (4096 - 256)
    mu = image_seq_len * m + (0.5 - m * 256)
    sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    nxt = np.concatenate([sigmas[1:], [0.0]])
    return (sigmas.astype(np.float32), nxt.astype(np.float32),
            (sigmas * 1000.0).astype(np.float32))


def euler(lat_tokens: torch.Tensor, out: torch.Tensor, sigma: float,
          sigma_next: float) -> torch.Tensor:
    """The Euler step in fp32 from the bf16 latents and velocity, back to
    bf16.  lat_tokens, out [1, base, 64] bf16."""
    s = torch.tensor(sigma, dtype=torch.float32, device=out.device)
    sn = torch.tensor(sigma_next, dtype=torch.float32, device=out.device)
    return (lat_tokens.float() + out.float() * (sn - s)).to(lat_tokens.dtype)


def _mod(x, shift, scale):
    return layer_norm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _heads(x, n, hd):
    b, s, _ = x.shape
    return x.view(b, s, 3, n, hd).permute(2, 0, 3, 1, 4)


def double_block(w, arith: Arith, p: str, image, text, temb_silu, ropes, cfg: dict):
    b, s_i, _ = image.shape
    s_t = text.shape[1]
    n, hd = cfg["num_heads"], cfg["head_dim"]
    img_cos, img_sin, txt_cos, txt_sin = ropes
    im = _lin(arith, w, f"{p}.img_mod", temb_silu).chunk(6, -1)
    tx = _lin(arith, w, f"{p}.txt_mod", temb_silu).chunk(6, -1)
    a = f"{p}.attn"
    iq, ik, iv = _heads(_lin(arith, w, f"{a}.img_qkv", _mod(image, im[0], im[1])), n, hd)
    tq, tk, tv = _heads(_lin(arith, w, f"{a}.txt_qkv", _mod(text, tx[0], tx[1])), n, hd)
    iq = rope(rms_norm(iq, w[f"{a}.norm_q.scale"].float()), img_cos, img_sin)
    ik = rope(rms_norm(ik, w[f"{a}.norm_k.scale"].float()), img_cos, img_sin)
    tq = rope(rms_norm(tq, w[f"{a}.norm_added_q.scale"].float()), txt_cos, txt_sin)
    tk = rope(rms_norm(tk, w[f"{a}.norm_added_k.scale"].float()), txt_cos, txt_sin)
    q, k, v = (torch.cat(pair, dim=2) for pair in ((tq, iq), (tk, ik), (tv, iv)))
    mask = torch.ones((b, s_t + s_i), dtype=torch.bool, device=image.device)
    out = attention(q, k, v, mask, arith).transpose(1, 2).reshape(b, s_t + s_i, n * hd)
    image = arith.act(image + im[2][:, None] * _lin(arith, w, f"{a}.to_out", out[:, s_t:]))
    text = arith.act(text + tx[2][:, None] * _lin(arith, w, f"{a}.to_add_out", out[:, :s_t]))

    def mlp(prefix, x, shift, scale):
        return _lin(arith, w, f"{prefix}.fc2",
                    gelu_tanh(_lin(arith, w, f"{prefix}.fc1", _mod(x, shift, scale))))

    image = arith.act(image + im[5][:, None] * mlp(f"{p}.img_mlp", image, im[3], im[4]))
    text = arith.act(text + tx[5][:, None] * mlp(f"{p}.txt_mlp", text, tx[3], tx[4]))
    return text, image


def single_block(w, arith: Arith, p: str, x, s_t: int, temb_silu, ropes, cfg: dict,
                 slim_base: int = 0):
    """x [B, S_t + S_i, D], the text rows first; the new x, or its first
    ``slim_base`` image rows for the last block."""
    b, s, d = x.shape
    n, hd = cfg["num_heads"], cfg["head_dim"]
    img_cos, img_sin, txt_cos, txt_sin = ropes
    shift, scale, gate = _lin(arith, w, f"{p}.mod", temb_silu).chunk(3, -1)
    h = _mod(x, shift, scale)
    q, k, v = _heads(_lin(arith, w, f"{p}.attn.qkv", h), n, hd)
    cos, sin = torch.cat([txt_cos, img_cos]), torch.cat([txt_sin, img_sin])
    q = rope(rms_norm(q, w[f"{p}.attn.norm_q.scale"].float()), cos, sin)
    k = rope(rms_norm(k, w[f"{p}.attn.norm_k.scale"].float()), cos, sin)
    rows = slice(s_t, s_t + slim_base) if slim_base else slice(None)
    q, x, h = q[:, :, rows], x[:, rows], h[:, rows]
    mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
    out = attention(q, k, v, mask, arith).transpose(1, 2).reshape(b, x.shape[1], d)
    m = gelu_tanh(_lin(arith, w, f"{p}.proj_mlp", h))
    return arith.act(x + gate[:, None] * _lin(arith, w, f"{p}.proj_out",
                                              torch.cat([out, m], dim=-1)))


def outer_weights(weights) -> dict:
    out = {}
    for g in ("x_embedder", "context_embedder", "time_embed", "guidance_embed", "pooled_embed",
              "norm_out", "proj_out"):
        out.update(weights(g))
    return out


def _embed(arith, outer, prefix, x):
    h = torch.nn.functional.silu(_lin(arith, outer, f"{prefix}.linear_1", x, block=False))
    return _lin(arith, outer, f"{prefix}.linear_2", h, block=False)


@torch.no_grad()
def dit_forward(weights, cfg: dict, img_tokens, txt_tokens, t_bf16, g_bf16, pooled, ropes,
                base: int, arith: Arith | None = None, table_dtype=torch.bfloat16):
    """The DiT's velocity for the first ``base`` image tokens, fp32.

    weights: ``group -> {name: tensor}``; img_tokens [B, S_i, 64] (target,
    then context); txt_tokens [B, S_t, 4096]; t_bf16 [B] (the bf16 timestep
    / 1000); g_bf16 [B] (the bf16 guidance); pooled [B, 768]; ropes
    (img_cos, img_sin, txt_cos, txt_sin) fp32 (:func:`tables`);
    table_dtype: what the embeddings' frequency table is rounded through."""
    arith = arith or Arith("fp32")
    outer = outer_weights(weights)
    image = arith.act(_lin(arith, outer, "x_embedder", img_tokens.float(), block=False))
    text = arith.act(_lin(arith, outer, "context_embedder", txt_tokens.float(), block=False))
    dim = cfg["time_dim"]
    vec = (_embed(arith, outer, "time_embed", timestep_embedding(t_bf16, dim, table_dtype))
           + _embed(arith, outer, "guidance_embed", timestep_embedding(g_bf16, dim, table_dtype))
           + _embed(arith, outer, "pooled_embed", pooled.float()))
    t_silu = torch.nn.functional.silu(vec)
    for i in range(cfg["num_layers"]):
        w = weights(f"blocks.{i}")
        text, image = double_block(w, arith, f"blocks.{i}", image, text, t_silu, ropes, cfg)
        del w
    s_t = text.shape[1]
    x = torch.cat([text, image], dim=1)
    del text, image
    last = cfg["num_single_layers"] - 1
    for i in range(cfg["num_single_layers"]):
        w = weights(f"single_blocks.{i}")
        x = single_block(w, arith, f"single_blocks.{i}", x, s_t, t_silu, ropes, cfg,
                         slim_base=base if i == last else 0)
        del w
    scale, shift = _lin(arith, outer, "norm_out.linear", t_silu, block=False).chunk(2, -1)
    x = layer_norm(x[:, :base]) * (1.0 + scale[:, None]) + shift[:, None]
    return _lin(arith, outer, "proj_out", x, block=False)
