"""Attention: the plain PyTorch versions (what XLA computes in the JAX
package) and the public dispatch of ``physicedit_tpu/ops/attention.py``.

The DiT joint attention and the VL prefill attention run through the
hand-written kernels in ``kernels/flash_attention.py``; the plain versions
here serve the paths the JAX package also leaves to XLA (VL decode, small
shapes, a bias in the BSND entry point) and the kernels' plain twins.

``attention(..., impl=)`` names the two implementations of the JAX
package's ``impl`` in the port's own words:

- ``"dense"`` (JAX ``"xla"``): :func:`sdpa_xla`, a dense softmax in plain
  torch ops;
- ``"kernels"`` (JAX ``"pallas"``): ``kernels.flash_attention.flash_attention``,
  the hand-written CUDA kernels (their plain versions for CPU tensors);
- ``"ring"`` (sequence-parallel) raises until the multi-GPU slice.

:func:`default_impl` gives ``"kernels"`` where CUDA is present, else
``"dense"``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
IMPLS = ("dense", "kernels")


def sdpa_bnsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_mask: torch.Tensor | None = None,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """Heads-major attention with an fp32 softmax.  q/k/v: [B, N, S, D];
    key_mask: optional [B, S_k] bool, False keys are excluded; bias: optional
    additive [B, 1 or N, S_q, S_k] (natural-log units)."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    if bias is not None:
        logits = logits + bias.float()
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def sdpa_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             key_mask: torch.Tensor | None = None,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`sdpa_bnsd` over [B, S, N, D] inputs and output (the JAX
    package's ``sdpa_xla``).  bias: [B, 1 or N, S_q, S_k], added to the
    [B, N, S_q, S_k] logits as it broadcasts."""
    out = sdpa_bnsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    key_mask=key_mask, bias=bias)
    return out.transpose(1, 2)


def attention(q, k, v, key_mask=None, bias=None, impl: str = "dense",
              variant: str = "fixedmax"):
    """Attention over [B, S, N, D] inputs.  ``variant`` (kernels only):
    ``"fixedmax"`` assumes bounded logits (the DiT RMS-norms q and k), where
    the clamp of 100 (exp2 units) flattens the softmax of larger ones;
    callers with unnormalised q and k must pass ``"online"``, the running-max
    kernel K10."""
    if impl == "dense":
        return sdpa_xla(q, k, v, key_mask=key_mask, bias=bias)
    if impl == "kernels":
        from physicedit_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, key_mask=key_mask, bias=bias, variant=variant)
    if impl == "ring":
        raise NotImplementedError("attn_impl='ring' (sequence-parallel attention) is not "
                                  "ported: it comes with the multi-GPU slice")
    raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")


def default_impl() -> str:
    """The hand-written kernels where a CUDA device is present, the dense
    softmax elsewhere."""
    return "kernels" if torch.cuda.is_available() else "dense"


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
