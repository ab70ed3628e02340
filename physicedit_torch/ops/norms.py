"""Normalisation and activation primitives, with the JAX package's dtype
discipline (``physicedit_tpu/ops/norms.py``): statistics in fp32, results
cast back to the input dtype before any affine."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with fp32 variance; ``rsqrt`` is cast to the input dtype
    before the multiply, as the reference does."""
    var = x.float().square().mean(-1, keepdim=True)
    x = (x * torch.rsqrt(var + eps).to(x.dtype)).to(x.dtype)
    if scale is not None:
        x = x * scale
    return x


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """LayerNorm with fp32 mean and (population) variance, affine optional."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def approximate_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the DiT MLP activation."""
    return x * torch.sigmoid(1.702 * x)


def l2_normalize_channel(x: torch.Tensor, dim: int,
                         eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` with the norm taken in fp32 (the VAE channel norm)."""
    norm = x.float().square().sum(dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps).to(x.dtype)).to(x.dtype)
