"""Plain attention in PyTorch (what XLA computes in the JAX package).

The DiT joint attention and the VL prefill attention run through the
hand-written kernels in ``kernels/flash_attention.py``; these plain versions
serve the paths the JAX package also leaves to XLA (VL decode, small
shapes) and the kernels' plain twins.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sdpa_bnsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Heads-major attention with an fp32 softmax.  q/k/v: [B, N, S, D];
    key_mask: optional [B, S_k] bool, False keys are excluded."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask_bias: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention without repeating K/V.

    q: [B, S, N, D]; k/v: [B, T, KV, D]; mask_bias: [B, 1, S, T] additive.
    Query head h reads K/V head h // (N / KV).  Returns [B, S, N * D].
    """
    b, s, n, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, n // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (d ** 0.5)
    logits = logits + mask_bias[:, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, n * d)


def causal_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] key validity -> additive [B, 1, S, S] causal + padding bias
    (causality by absolute position, so left and right padding both work)."""
    s = key_mask.shape[1]
    pos = torch.arange(s, device=key_mask.device)
    ok = (pos[None, :] <= pos[:, None])[None] & key_mask[:, None, :]
    return torch.where(ok, 0.0, NEG_INF)[:, None].float()
