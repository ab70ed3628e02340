"""The PhysicEdit adapter stack (``physicedit_tpu/models/adapters.py``).

- :class:`PerceiverResampler`: learned latents cross-attend to the media
  tokens and themselves, learned absolute position embedding, depth 2 with
  8 x 64 heads, final LayerNorm.
- the VisualThinking adapter: Linear(out * 3) -> exact GELU -> Linear.
- :class:`DualAdapter`: alpha(t) * head_dino(x) + (1 - alpha) * head_vae(x),
  which rewrites the 64 special-token embeddings at every denoise step, and
  :func:`dual_adapter_loss`, its alpha-weighted training MSE.

Every linear runs in the promoted dtype of its input and its weights, as
``jnp`` promotes: a bf16 prompt embedding through fp32 trainable adapters
comes out fp32, and the caller casts back where the JAX package casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, init_random_, linear, linear_promoted
from physicedit_torch.ops.norms import layer_norm

SPECIAL_TOKEN_NUM = 64


def visual_thinking_head(in_dim: int, out_dim: int, dtype=None) -> nn.ModuleDict:
    """A VisualThinking adapter, Linear(out * 3) -> exact GELU -> Linear
    (built on ``meta``)."""
    return nn.ModuleDict({"fc1": linear(in_dim, out_dim * 3, dtype=dtype),
                          "fc2": linear(out_dim * 3, out_dim, dtype=dtype)})


def visual_thinking_adapter(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    return linear_promoted(p["fc2"], F.gelu(linear_promoted(p["fc1"], x)))


class DualAdapter(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, in_dim: int = 3584, out_dim: int = 3584, dtype=None):
        super().__init__()
        self.head_dino = visual_thinking_head(in_dim, out_dim, dtype)
        self.head_vae = visual_thinking_head(in_dim, out_dim, dtype)


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


def dual_adapter_loss(pred_dino, pred_vae, gt_dino, gt_vae, timestep,
                      t_min: float, t_max: float, epsilon: float = 0.1):
    """Alpha-weighted dual MSE, fp32."""
    alpha = dual_adapter_alpha(timestep, t_min, t_max)
    loss_dino = (pred_dino.float() - gt_dino.float()).square().mean(dim=(1, 2))
    loss_vae = (pred_vae.float() - gt_vae.float()).square().mean(dim=(1, 2))
    w = alpha.reshape(-1)
    w_dino = w + epsilon
    w_vae = (1 - w) + epsilon
    total = w_dino + w_vae
    return ((w_dino / total) * loss_dino + (w_vae / total) * loss_vae).mean()


# ---------------------------------------------------------------------------
# PerceiverResampler
# ---------------------------------------------------------------------------

def _ln(p: Leaf, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, eps=1e-5, scale=p.scale, bias=p.bias)


def perceiver_attention(p: nn.ModuleDict, x, latents, heads: int = 8, dim_head: int = 64,
                        media_mask=None):
    """Latents query (media + latents).  media_mask: optional [B, N] bool;
    False media tokens are left out of the keys (zero-padded frames)."""
    b, m, _ = latents.shape
    xn = _ln(p["norm_media"], x)
    ln = _ln(p["norm_latents"], latents)
    q = linear_promoted(p["to_q"], ln)
    kv = linear_promoted(p["to_kv"], torch.cat([xn, ln], dim=1))
    k, v = kv.chunk(2, dim=-1)

    def split_heads(t):
        return t.reshape(t.shape[0], t.shape[1], heads, dim_head).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dim_head ** -0.5)
    if media_mask is not None:
        full = torch.cat([media_mask.bool(),
                          torch.ones((b, m), dtype=torch.bool, device=media_mask.device)], 1)
        logits = torch.where(full[:, None, None, :], logits, -1e30)
    logits = logits - logits.amax(-1, keepdim=True).detach()
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, m, heads * dim_head)
    return linear_promoted(p["to_out"], out)


def perceiver_ff(p: nn.ModuleDict, x):
    """LN -> Linear(4x) -> exact GELU -> Linear."""
    return linear_promoted(p["fc2"], F.gelu(linear_promoted(p["fc1"], _ln(p["norm"], x))))


class PerceiverResampler(nn.Module):
    """[B, N, dim] media tokens -> [B, num_latents, dim]; the JAX tree
    ``{"latents", "pos_emb", "layers": [{"attn", "ff"}], "norm"}``.  Built on
    the ``meta`` device."""

    def __init__(self, dim: int, depth: int = 2, dim_head: int = 64, heads: int = 8,
                 num_latents: int = SPECIAL_TOKEN_NUM, max_num_media_tokens: int = 4096,
                 dtype=None):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head

        def ln():
            return Leaf(scale=(dim,), bias=(dim,), dtype=dtype)

        self.latents = nn.Parameter(torch.empty((num_latents, dim), dtype=dtype, device="meta"),
                                    requires_grad=False)
        self.pos_emb = nn.Parameter(torch.empty((max_num_media_tokens, dim), dtype=dtype,
                                                device="meta"), requires_grad=False)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "attn": nn.ModuleDict({
                "norm_media": ln(), "norm_latents": ln(),
                "to_q": linear(dim, inner, bias=False, dtype=dtype),
                "to_kv": linear(dim, inner * 2, bias=False, dtype=dtype),
                "to_out": linear(inner, dim, bias=False, dtype=dtype)}),
            "ff": nn.ModuleDict({
                "norm": ln(),
                "fc1": linear(dim, dim * 4, dtype=dtype),
                "fc2": linear(dim * 4, dim, dtype=dtype)}),
        }) for _ in range(depth))
        self.norm = ln()

    def forward(self, x: torch.Tensor, media_mask=None) -> torch.Tensor:
        b, n, _ = x.shape
        latents = self.latents.expand(b, *self.latents.shape)
        x = x + self.pos_emb[:n][None].to(x.dtype)
        for layer in self.layers:
            latents = latents + perceiver_attention(layer["attn"], x, latents, self.heads,
                                                    self.dim_head, media_mask)
            latents = latents + perceiver_ff(layer["ff"], latents)
        return _ln(self.norm, latents)


@torch.no_grad()
def init_perceiver_(resampler: PerceiverResampler, generator: torch.Generator):
    """The JAX ``init_perceiver_params`` distribution on a materialised
    resampler: torch-default linears, LayerNorms at (1, 0), latents
    N(0, 0.02^2), pos_emb N(0, 1)."""
    init_random_(resampler, generator)
    resampler.latents.normal_(0.0, 0.02, generator=generator)
    resampler.pos_emb.normal_(0.0, 1.0, generator=generator)
    return resampler
