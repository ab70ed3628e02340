"""PhysicEdit's dual VisualThinking adapter, plain fp32: two heads, each
``fc2(gelu(fc1(x)))`` with the exact GELU and ``fc1`` three times as wide,
mixed as ``alpha(t) * dino + (1 - alpha) * vae`` with ``alpha(t) =
clip((t - t_min) / (t_max - t_min + 1e-6), 0, 1)``; at every denoise step
it rewrites the 64 special-token rows of the prompt embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pebench.reference.arith import Arith


def _head(arith, w, p, x):
    h = F.gelu(arith.linear(x, w[f"{p}.fc1.weight"], w[f"{p}.fc1.bias"], block=False))
    return arith.linear(h, w[f"{p}.fc2.weight"], w[f"{p}.fc2.bias"], block=False)


@torch.no_grad()
def rewrite(weights, rows: torch.Tensor, special_idx: torch.Tensor, timestep: float,
            t_range: tuple, arith: Arith | None = None) -> torch.Tensor:
    """rows [B, S_t, D] (fp32 copy returned); special_idx [B, 64]."""
    arith = arith or Arith("fp32")
    w = {}
    for g in ("head_dino", "head_vae"):
        w.update(weights(g))
    t_min, t_max = t_range
    alpha = min(max((timestep - t_min) / (t_max - t_min + 1e-6), 0.0), 1.0)
    b = torch.arange(rows.shape[0], device=rows.device)[:, None]
    x = rows[b, special_idx].float()
    mixed = alpha * _head(arith, w, "head_dino", x) + (1 - alpha) * _head(arith, w, "head_vae", x)
    out = rows.float().clone()
    out[b, special_idx] = mixed
    return out
