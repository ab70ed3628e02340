"""Qwen-Image VAE, image mode (``physicedit_tpu/models/vae.py``).

For a single frame the reference's causal 3D convolutions reduce exactly to
2D convolutions (only the last temporal tap meets the input), so this is a
2D conv network.  The public functions keep the JAX package's NHWC layout;
inside, the convolutions run as NCHW ``F.conv2d``.  Weights of
``nn.Conv2d`` are OIHW (the JAX package keeps HWIO).

The forward functions also take the video mode's 5-D ``[B, C, T, H, W]``
activations (``models/vae3d.py``): its residual convolutions are
:class:`CausalConv3d`, and the spatial-only ops (attention, down and up
sampling) run per frame through :func:`per_frame`.
"""

from __future__ import annotations

import dataclasses
import functools

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

class CausalConv3d(nn.Conv3d):
    """A Conv3d with ``kt - 1`` zero frames padded in front of time
    (qwen_image_vae.py:40-50) and spatial SAME padding; weights OIDHW, the
    reference's own layout."""

    def forward(self, x):
        kt = self.kernel_size[0]
        if kt > 1:
            x = F.pad(x, (0, 0, 0, 0, kt - 1, 0))
        return super().forward(x)


def _conv(cin, cout, k, dtype, kt=None):
    """A SAME conv: 2-D, or causal 3-D with ``kt`` temporal taps."""
    if kt is None:
        return nn.Conv2d(cin, cout, k, padding=k // 2, dtype=dtype, device="meta")
    return CausalConv3d(cin, cout, (kt, k, k), padding=(0, k // 2, k // 2), dtype=dtype,
                        device="meta")


def _norm(c, dtype):
    return Leaf(gamma=(c,), dtype=dtype)


def _res(cin, cout, dtype, kt=None):
    p = nn.ModuleDict({"norm1": _norm(cin, dtype), "conv1": _conv(cin, cout, 3, dtype, kt),
                       "norm2": _norm(cout, dtype), "conv2": _conv(cout, cout, 3, dtype, kt)})
    if cin != cout:
        p["shortcut"] = _conv(cin, cout, 1, dtype, kt and 1)
    return p


def _mid(c, dtype, kt=None):
    return nn.ModuleDict({
        "res0": _res(c, c, dtype, kt),
        "attn": nn.ModuleDict({"norm": _norm(c, dtype), "to_qkv": _conv(c, 3 * c, 1, dtype),
                               "proj": _conv(c, c, 1, dtype)}),
        "res1": _res(c, c, dtype, kt),
    })


def _down(c, dtype):
    # ZeroPad2d(right, bottom) + stride-2 3x3 conv; encoder_forward pads
    return nn.Conv2d(c, c, 3, stride=2, padding=0, dtype=dtype, device="meta")


class VAE(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    temporal_taps = None    # 3 in video mode: the residual convs are causal 3-D

    def __init__(self, cfg: VAEConfig = QWEN_VAE_CONFIG, dtype=None):
        super().__init__()
        self.cfg = cfg
        kt = self.temporal_taps
        enc_dims, dec_dims, n_st = cfg.enc_dims, cfg.dec_dims, len(cfg.dim_mult)
        enc_stages = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
            res = [_res(cin, cout, dtype, kt)] + [_res(cout, cout, dtype, kt)
                                                  for _ in range(cfg.num_res_blocks - 1)]
            stage = nn.ModuleDict({"res": nn.ModuleList(res)})
            if i != n_st - 1:
                stage["down"] = _down(cout, dtype)
            enc_stages.append(stage)
        dec_stages = nn.ModuleList()
        for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
            cin = cin // 2 if i > 0 else cin
            res = [_res(cin, cout, dtype, kt)] + [_res(cout, cout, dtype, kt)
                                                  for _ in range(cfg.num_res_blocks)]
            stage = nn.ModuleDict({"res": nn.ModuleList(res)})
            if i != n_st - 1:
                stage["up"] = _conv(cout, cout // 2, 3, dtype)
            dec_stages.append(stage)
        z2 = cfg.z_dim * 2
        self.encoder = nn.ModuleDict({
            "conv_in": _conv(3, enc_dims[0], 3, dtype, kt), "stages": enc_stages,
            "mid": _mid(enc_dims[-1], dtype, kt), "norm_out": _norm(enc_dims[-1], dtype),
            "conv_out": _conv(enc_dims[-1], z2, 3, dtype, kt)})
        self.decoder = nn.ModuleDict({
            "conv_in": _conv(cfg.z_dim, dec_dims[0], 3, dtype, kt),
            "mid": _mid(dec_dims[0], dtype, kt), "stages": dec_stages,
            "norm_out": _norm(dec_dims[-1], dtype),
            "conv_out": _conv(dec_dims[-1], 3, 3, dtype, kt)})
        self.quant_conv = _conv(z2, z2, 1, dtype)
        self.post_quant_conv = _conv(cfg.z_dim, cfg.z_dim, 1, dtype)


# ---------------------------------------------------------------------------
# Forward (NCHW, or NCTHW in video mode, inside)
# ---------------------------------------------------------------------------

def per_frame(fn, x):
    """A 2-D op on each frame of a 5-D ``[B, C, T, H, W]`` video, T folded
    into the batch (a view when ``x`` is channels-last-3d); a 4-D ``x``
    goes straight to ``fn``."""
    if x.dim() == 4:
        return fn(x)
    b, c, t, h, w = x.shape
    y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


def _channel_rms(p: Leaf, x):
    """Per-position channel L2 norm scaled by sqrt(C) and a learned gamma."""
    c = x.shape[1]
    gamma = p.gamma.reshape(c, *(1,) * (x.dim() - 2))
    return l2_normalize_channel(x, dim=1) * (c ** 0.5) * gamma


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
    x = per_frame(functools.partial(_attn_block, p["attn"]), _res_block(p["res0"], x))
    return _res_block(p["res1"], x)


def _downsample(conv, x):
    return conv(F.pad(x, (0, 1, 0, 1)))     # ZeroPad2d(right, bottom), stride 2


def _upsample(conv, x):
    return conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def encoder_forward(p, x):
    x = p["conv_in"](x)
    for stage in p["stages"]:
        for res in stage["res"]:
            x = _res_block(res, x)
        if "down" in stage:
            x = per_frame(functools.partial(_downsample, stage["down"]), x)
    x = _mid_block(p["mid"], x)
    return p["conv_out"](F.silu(_channel_rms(p["norm_out"], x)))


def decoder_forward(p, x):
    x = _mid_block(p["mid"], p["conv_in"](x))
    for stage in p["stages"]:
        for res in stage["res"]:
            x = _res_block(res, x)
        if "up" in stage:
            x = per_frame(functools.partial(_upsample, stage["up"]), x)
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
