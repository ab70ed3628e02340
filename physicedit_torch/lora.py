"""The DiT's trainable LoRA factors (the trainable-factor half of
``physicedit_tpu/lora/__init__.py``).

The factors are stacked along the layer axis as in the JAX package, so a
tree of weights or gradients carries across by name: ``img_qkv`` and
``txt_qkv`` hold ``A [L, 3, dim, r]`` and ``B [L, 3, r, dim]`` (the three
projections of the fused QKV), ``to_out``, ``to_add_out``, ``img_mlp_fc2``,
``txt_mlp_fc2``, ``img_mod`` and ``txt_mod`` hold ``A [L, in, r]`` and
``B [L, r, out]``.  Deltas are applied on activations, ``y += (x @ A) @ B``,
in the promoted dtype of x and the factors; the DiT casts the delta to its
own dtype.  :func:`export_dit_lora` writes the reference's peft keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from physicedit_torch.core.params import Leaf, materialize

# framework block path -> (reference module names, fused parts)
_FUSED = {
    "img_qkv": ("attn.to_q", "attn.to_k", "attn.to_v"),
    "txt_qkv": ("attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj"),
}
_PLAIN = {
    "to_out": "attn.to_out.0",
    "to_add_out": "attn.to_add_out",
    "img_mlp_fc2": "img_mlp.net.2",
    "txt_mlp_fc2": "txt_mlp.net.2",
    "img_mod": "img_mod.1",
    "txt_mod": "txt_mod.1",
}


def _shapes(cfg) -> dict:
    d = cfg.dim
    return {"img_qkv": (d, d, 3), "txt_qkv": (d, d, 3), "to_out": (d, d, 0),
            "to_add_out": (d, d, 0), "img_mlp_fc2": (cfg.mlp_dim, d, 0),
            "txt_mlp_fc2": (cfg.mlp_dim, d, 0), "img_mod": (d, 6 * d, 0),
            "txt_mod": (d, 6 * d, 0)}


class DiTLoRA(nn.Module):
    """The JAX tree ``{name: {"A", "B"}}``, one :class:`Leaf` per name;
    built on the ``meta`` device."""

    def __init__(self, cfg, rank: int = 128, dtype=None):
        super().__init__()
        self.num_layers, self.rank = cfg.num_layers, rank
        L = cfg.num_layers
        for name, (ins, outs, parts) in _shapes(cfg).items():
            lead = (L, parts) if parts else (L,)
            self.add_module(name, Leaf(A=lead + (ins, rank), B=lead + (rank, outs),
                                       dtype=dtype))

    def layers(self) -> list:
        """Each layer's factors, ``[{name: {"A", "B"}}]``: views from one
        ``unbind`` per factor, so the backward stacks the layers' gradients
        into the factor once (an index per layer would add a zero-filled
        full-size gradient per layer)."""
        split = {name: (leaf.A.unbind(0), leaf.B.unbind(0))
                 for name, leaf in self.named_children()}
        return [{name: {"A": a[i], "B": b[i]} for name, (a, b) in split.items()}
                for i in range(self.num_layers)]


@torch.no_grad()
def init_dit_lora(cfg, rank: int = 128, dtype=torch.float32, device="cuda",
                  generator: torch.Generator | None = None) -> DiTLoRA:
    """Fresh factors: A ~ N(0, 1/in) (Kaiming-style), B = 0, so the delta
    starts at 0 (the peft convention; ``init_dit_lora`` of the JAX package)."""
    lora = materialize(DiTLoRA(cfg, rank, dtype), device)
    for leaf in lora.children():
        ins = leaf.A.shape[-2]
        leaf.A.normal_(0.0, 1.0, generator=generator).mul_(1.0 / math.sqrt(ins))
        leaf.B.zero_()
    return lora


def _promote(x: torch.Tensor, *ws: torch.Tensor):
    dt = x.dtype
    for w in ws:
        dt = torch.promote_types(dt, w.dtype)
    return (x.to(dt),) + tuple(w.to(dt) for w in ws)


def lora_delta(leaf: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., in]; A [in, r], B [r, out] -> [..., out]."""
    x, a, b = _promote(x, leaf["A"], leaf["B"])
    return (x @ a) @ b


def lora_delta_fused(leaf: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, in]; A [3, in, r], B [3, r, out] -> [B, S, 3 * out]."""
    x, a, b = _promote(x, leaf["A"], leaf["B"])
    t = torch.einsum("bsi,pir->bspr", x, a)
    d = torch.einsum("bspr,pro->bspo", t, b)
    return d.reshape(x.shape[0], x.shape[1], -1)


def export_dit_lora(lora: DiTLoRA, prefix: str = "pipe.dit.") -> dict:
    """Factors -> the reference's peft keys (NumPy fp32, torch layout):
    ``{prefix}transformer_blocks.{i}.{module}.lora_{A,B}.default.weight``
    with A ``[r, in]`` and B ``[out, r]``."""
    out = {}
    host = {name: {"A": leaf.A.detach().float().cpu().numpy(),
                   "B": leaf.B.detach().float().cpu().numpy()}
            for name, leaf in lora.named_children()}

    def put(i, module, a, b):
        out[f"{prefix}transformer_blocks.{i}.{module}.lora_A.default.weight"] = np.ascontiguousarray(a.T)
        out[f"{prefix}transformer_blocks.{i}.{module}.lora_B.default.weight"] = np.ascontiguousarray(b.T)

    for i in range(lora.num_layers):
        for name, modules in _FUSED.items():
            for p, module in enumerate(modules):
                put(i, module, host[name]["A"][i, p], host[name]["B"][i, p])
        for name, module in _PLAIN.items():
            put(i, module, host[name]["A"][i], host[name]["B"][i])
    return out
