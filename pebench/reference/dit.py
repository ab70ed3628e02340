"""The Qwen-Image MM-DiT forward in plain PyTorch, fp32, one block at a time.

Follows the published model (diffusers ``QwenImageTransformer2DModel``, the
60 dual-stream blocks of Qwen-Image): an image and a text stream, each with
its own adaLN modulation (shift, scale, gate twice), fused QKV projection,
per-head RMSNorm of q and k, the 3-axis scaled RoPE on adjacent pairs, one
joint softmax attention over text then image with the text padding masked
as keys, output projections, and a GELU MLP (``x * sigmoid(1.702 x)``).
The last block is queried only by the output image's rows, as only those
reach the output.  The time embedding is sinusoidal on the timestep the
bf16 deployment hands the model (``t / 1000`` rounded to bf16, the
frequency table rounded through bf16 as the published code does in bf16).

Weights come from ``weights(group)``: a dict of tensors named as the
port's state dict (``blocks.7.attn.img_qkv.weight``), drawn again per
group, so only one block is held in fp32 at a time.  Departure from the
published model: none in the arithmetic; the attention is computed head
chunk by head chunk so that the fp32 scores fit beside the weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pebench.reference.arith import Arith

EPS = 1e-6
# heads a chunk of the fp32 attention: 4 x 8832^2 scores are 1.25 GB
HEADS_PER_CHUNK = 4


def layer_norm(x):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + EPS)


def rms_norm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope(x, cos, sin):
    """Rotate adjacent pairs of the last dim; x [B, N, S, D], cos [S, D/2]."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x0 * cos - x1 * sin
    out[..., 1::2] = x1 * cos + x0 * sin
    return out


def gelu_approx(x):
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t_bf16: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(t_bf16.device)
    freqs = freqs.to(torch.bfloat16).float()
    ang = t_bf16.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def attention(q, k, v, key_mask, arith: Arith | None = None):
    """Softmax attention, fp32 (or the operands as ``arith`` holds them).
    q [B, N, Sq, D]; k, v [B, N, Sk, D]; key_mask [B, Sk] bool (False =
    padding)."""
    arith = arith or Arith("fp32")
    q, k, v = arith.act(q), arith.act(k), arith.act(v)
    b, n, _, d = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    for i in range(b):
        bias = torch.zeros(key_mask.shape[1], device=q.device)
        bias[~key_mask[i]] = float("-inf")
        for h0 in range(0, n, HEADS_PER_CHUNK):
            h1 = min(n, h0 + HEADS_PER_CHUNK)
            s = (q[i, h0:h1] @ k[i, h0:h1].transpose(-1, -2)) * scale + bias
            out[i, h0:h1] = arith.act(torch.softmax(s, dim=-1)) @ v[i, h0:h1]
    return out


def _lin(arith, w, prefix, x, block=True):
    return arith.linear(x, w[prefix + ".weight"], w.get(prefix + ".bias"), block)


def block_forward(w, arith: Arith, p: str, image, text, temb_silu, ropes, key_mask,
                  cfg: dict, slim_base: int = 0):
    """One dual-stream block (prefix ``p``, e.g. ``blocks.7``); returns
    (text, image), or (None, image[:, :slim_base]) for the slim last block."""
    b, s_i, _ = image.shape
    s_t = text.shape[1]
    hd = cfg["head_dim"]
    n = cfg["num_heads"]
    img_cos, img_sin, txt_cos, txt_sin = ropes
    im = _lin(arith, w, f"{p}.img_mod", temb_silu).chunk(6, -1)
    tx = _lin(arith, w, f"{p}.txt_mod", temb_silu).chunk(6, -1)

    def mod(x, shift, scale):
        return layer_norm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]

    def heads(x, s):
        return x.view(b, s, 3, n, hd).permute(2, 0, 3, 1, 4)

    iq, ik, iv = heads(_lin(arith, w, f"{p}.attn.img_qkv", mod(image, im[0], im[1])), s_i)
    tq, tk, tv = heads(_lin(arith, w, f"{p}.attn.txt_qkv", mod(text, tx[0], tx[1])), s_t)
    a = f"{p}.attn"
    iq = rope(rms_norm(iq, w[f"{a}.norm_q.scale"].float()), img_cos, img_sin)
    ik = rope(rms_norm(ik, w[f"{a}.norm_k.scale"].float()), img_cos, img_sin)
    tq = rope(rms_norm(tq, w[f"{a}.norm_added_q.scale"].float()), txt_cos, txt_sin)
    tk = rope(rms_norm(tk, w[f"{a}.norm_added_k.scale"].float()), txt_cos, txt_sin)
    k = torch.cat([tk, ik], dim=2)
    v = torch.cat([tv, iv], dim=2)
    mask = torch.cat([key_mask, torch.ones((b, s_i), dtype=torch.bool,
                                           device=key_mask.device)], dim=1)

    def mlp(prefix, x, shift, scale):
        h = gelu_approx(_lin(arith, w, f"{prefix}.fc1", mod(x, shift, scale)))
        return _lin(arith, w, f"{prefix}.fc2", h)

    if slim_base:
        q = iq[:, :, :slim_base]
        out = attention(q, k, v, mask, arith)
        out = out.transpose(1, 2).reshape(b, slim_base, n * hd)
        image = arith.act(image[:, :slim_base]
                          + im[2][:, None] * _lin(arith, w, f"{a}.to_out", out))
        image = arith.act(image + im[5][:, None] * mlp(f"{p}.img_mlp", image, im[3], im[4]))
        return None, image

    q = torch.cat([tq, iq], dim=2)
    out = attention(q, k, v, mask, arith)
    out = out.transpose(1, 2).reshape(b, s_t + s_i, n * hd)
    image = arith.act(image + im[2][:, None] * _lin(arith, w, f"{a}.to_out", out[:, s_t:]))
    text = arith.act(text + tx[2][:, None] * _lin(arith, w, f"{a}.to_add_out", out[:, :s_t]))
    image = arith.act(image + im[5][:, None] * mlp(f"{p}.img_mlp", image, im[3], im[4]))
    text = arith.act(text + tx[5][:, None] * mlp(f"{p}.txt_mlp", text, tx[3], tx[4]))
    return text, image


def outer_weights(weights) -> dict:
    out = {}
    for g in ("img_in", "txt_norm", "txt_in", "time_embed", "norm_out", "proj_out"):
        out.update(weights(g))
    return out


def temb_silu(outer: dict, cfg: dict, t_bf16, arith: Arith):
    """silu of the time embedding: the input of every modulation."""
    temb = timestep_embedding(t_bf16, cfg["time_dim"])
    hidden = torch.nn.functional.silu(_lin(arith, outer, "time_embed.linear_1", temb,
                                           block=False))
    return torch.nn.functional.silu(_lin(arith, outer, "time_embed.linear_2", hidden,
                                         block=False))


@torch.no_grad()
def dit_forward(weights, cfg: dict, img_tokens, txt_tokens, t_bf16, ropes, key_mask,
                base: int, arith: Arith | None = None):
    """The DiT's velocity for the first ``base`` image tokens, fp32.

    weights: ``group -> {name: tensor}``; img_tokens [B, S_i, 64]; txt_tokens
    [B, S_t, txt_in_dim]; t_bf16 [B] (the bf16 timestep / 1000); ropes
    (img_cos, img_sin, txt_cos, txt_sin) fp32; key_mask [B, S_t] bool."""
    arith = arith or Arith("fp32")
    outer = outer_weights(weights)
    image = arith.act(_lin(arith, outer, "img_in", img_tokens.float(), block=False))
    text = arith.act(_lin(arith, outer, "txt_in",
                          rms_norm(txt_tokens.float(), outer["txt_norm.scale"].float()),
                          block=False))
    t_silu = temb_silu(outer, cfg, t_bf16, arith)
    layers = cfg["num_layers"]
    for i in range(layers):
        w = weights(f"blocks.{i}")
        text, image = block_forward(w, arith, f"blocks.{i}", image, text, t_silu, ropes,
                                    key_mask, cfg, slim_base=base if i == layers - 1 else 0)
        del w
    scale, shift = _lin(arith, outer, "norm_out.linear", t_silu, block=False).chunk(2, -1)
    image = layer_norm(image[:, :base]) * (1.0 + scale[:, None]) + shift[:, None]
    return _lin(arith, outer, "proj_out", image, block=False)
