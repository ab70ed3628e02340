"""Qwen-Image VAE, image mode (``physicedit_tpu/models/vae.py``).

For a single frame the reference's causal 3D convolutions reduce exactly to
2D convolutions (only the last temporal tap meets the input), so this is a
2D conv network.  The public functions keep the JAX package's NHWC layout;
inside, the convolutions run as NCHW ``F.conv2d``.  Weights of
``nn.Conv2d`` are OIHW (the JAX package keeps HWIO).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf
from physicedit_torch.ops.norms import l2_normalize_channel


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2

    @property
    def enc_dims(self):
        return [self.base_dim * u for u in (1,) + tuple(self.dim_mult)]

    @property
    def dec_dims(self):
        m = tuple(self.dim_mult)
        return [self.base_dim * u for u in (m[-1],) + m[::-1]]


QWEN_VAE_CONFIG = VAEConfig()

LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], dtype=np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], dtype=np.float32)


# ---------------------------------------------------------------------------
# Structure (attribute names follow the JAX parameter tree)
# ---------------------------------------------------------------------------

def _conv(cin, cout, k, dtype):
    return nn.Conv2d(cin, cout, k, padding=k // 2, dtype=dtype, device="meta")


def _norm(c, dtype):
    return Leaf(gamma=(c,), dtype=dtype)


def _res(cin, cout, dtype):
    p = nn.ModuleDict({"norm1": _norm(cin, dtype), "conv1": _conv(cin, cout, 3, dtype),
                       "norm2": _norm(cout, dtype), "conv2": _conv(cout, cout, 3, dtype)})
    if cin != cout:
        p["shortcut"] = _conv(cin, cout, 1, dtype)
    return p


def _mid(c, dtype):
    return nn.ModuleDict({
        "res0": _res(c, c, dtype),
        "attn": nn.ModuleDict({"norm": _norm(c, dtype), "to_qkv": _conv(c, 3 * c, 1, dtype),
                               "proj": _conv(c, c, 1, dtype)}),
        "res1": _res(c, c, dtype),
    })


def _down(c, dtype):
    # ZeroPad2d(right, bottom) + stride-2 3x3 conv; encoder_forward pads
    return nn.Conv2d(c, c, 3, stride=2, padding=0, dtype=dtype, device="meta")


class VAE(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, cfg: VAEConfig = QWEN_VAE_CONFIG, dtype=None):
        super().__init__()
        self.cfg = cfg
        enc_dims, dec_dims, n_st = cfg.enc_dims, cfg.dec_dims, len(cfg.dim_mult)
        enc_stages = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
            res = [_res(cin, cout, dtype)] + [_res(cout, cout, dtype)
                                              for _ in range(cfg.num_res_blocks - 1)]
            stage = nn.ModuleDict({"res": nn.ModuleList(res)})
            if i != n_st - 1:
                stage["down"] = _down(cout, dtype)
            enc_stages.append(stage)
        dec_stages = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
            cin = cin // 2 if i > 0 else cin
            res = [_res(cin, cout, dtype)] + [_res(cout, cout, dtype)
                                              for _ in range(cfg.num_res_blocks)]
            stage = nn.ModuleDict({"res": nn.ModuleList(res)})
            if i != n_st - 1:
                stage["up"] = _conv(cout, cout // 2, 3, dtype)
            dec_stages.append(stage)
        z2 = cfg.z_dim * 2
        self.encoder = nn.ModuleDict({
            "conv_in": _conv(3, enc_dims[0], 3, dtype), "stages": enc_stages,
            "mid": _mid(enc_dims[-1], dtype), "norm_out": _norm(enc_dims[-1], dtype),
            "conv_out": _conv(enc_dims[-1], z2, 3, dtype)})
        self.decoder = nn.ModuleDict({
            "conv_in": _conv(cfg.z_dim, dec_dims[0], 3, dtype),
            "mid": _mid(dec_dims[0], dtype), "stages": dec_stages,
            "norm_out": _norm(dec_dims[-1], dtype),
            "conv_out": _conv(dec_dims[-1], 3, 3, dtype)})
        self.quant_conv = _conv(z2, z2, 1, dtype)
        self.post_quant_conv = _conv(cfg.z_dim, cfg.z_dim, 1, dtype)


# ---------------------------------------------------------------------------
# Forward (NCHW inside)
# ---------------------------------------------------------------------------

def _channel_rms(p: Leaf, x):
    """Per-position channel L2 norm scaled by sqrt(C) and a learned gamma."""
    c = x.shape[1]
    return l2_normalize_channel(x, dim=1) * (c ** 0.5) * p.gamma[:, None, None]


def _res_block(p, x):
    h = p["shortcut"](x) if "shortcut" in p else x
    x = p["conv1"](F.silu(_channel_rms(p["norm1"], x)))
    x = p["conv2"](F.silu(_channel_rms(p["norm2"], x)))
    return x + h


def _attn_block(p, x):
    """Single-head spatial self-attention with an fp32 softmax."""
    b, c, h, w = x.shape
    qkv = p["to_qkv"](_channel_rms(p["norm"], x)).reshape(b, 3, c, h * w)
    q, k, v = (qkv[:, i].transpose(1, 2) for i in range(3))
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / (c ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, c, h, w)
    return p["proj"](out) + x


def _mid_block(p, x):
    return _res_block(p["res1"], _attn_block(p["attn"], _res_block(p["res0"], x)))


def encoder_forward(p, x):
    x = p["conv_in"](x)
    for stage in p["stages"]:
        for res in stage["res"]:
            x = _res_block(res, x)
        if "down" in stage:
            x = stage["down"](F.pad(x, (0, 1, 0, 1)))
    x = _mid_block(p["mid"], x)
    return p["conv_out"](F.silu(_channel_rms(p["norm_out"], x)))


def decoder_forward(p, x):
    x = _mid_block(p["mid"], p["conv_in"](x))
    for stage in p["stages"]:
        for res in stage["res"]:
            x = _res_block(res, x)
        if "up" in stage:
            x = stage["up"](F.interpolate(x, scale_factor=2, mode="nearest"))
    return p["conv_out"](F.silu(_channel_rms(p["norm_out"], x)))


def _stats(x):
    mean = torch.from_numpy(LATENT_MEAN).to(device=x.device, dtype=x.dtype)
    std = torch.from_numpy(LATENT_STD).to(device=x.device, dtype=x.dtype)
    return mean, std


@torch.no_grad()
def encode(vae: VAE, x: torch.Tensor) -> torch.Tensor:
    """Image [B, H, W, 3] in [-1, 1] -> normalised latent [B, H/8, W/8, 16]."""
    z = encoder_forward(vae.encoder, x.permute(0, 3, 1, 2))
    z = vae.quant_conv(z)[:, :vae.cfg.z_dim].permute(0, 2, 3, 1)
    mean, std = _stats(z)
    return (z - mean) / std


@torch.no_grad()
def decode(vae: VAE, z: torch.Tensor) -> torch.Tensor:
    """Normalised latent [B, h, w, 16] -> image [B, 8h, 8w, 3] (about [-1, 1])."""
    mean, std = _stats(z)
    z = (z * std + mean).permute(0, 3, 1, 2)
    img = decoder_forward(vae.decoder, vae.post_quant_conv(z))
    return img.permute(0, 2, 3, 1)
