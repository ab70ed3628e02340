"""The DiT's LoRA (``physicedit_tpu/lora/__init__.py``): trainable factors,
their peft export and import, and the offline merge of a reference-format
LoRA file into a state dict.

The factors are stacked along the layer axis as in the JAX package, so a
tree of weights or gradients carries across by name: ``img_qkv`` and
``txt_qkv`` hold ``A [L, 3, dim, r]`` and ``B [L, 3, r, dim]`` (the three
projections of the fused QKV), ``to_out``, ``to_add_out``, ``img_mlp_fc2``,
``txt_mlp_fc2``, ``img_mod`` and ``txt_mod`` hold ``A [L, in, r]`` and
``B [L, r, out]``.  Deltas are applied on activations, ``y += (x @ A) @ B``,
in the promoted dtype of x and the factors; the DiT casts the delta to its
own dtype.  :func:`export_dit_lora` writes the reference's peft keys,
:func:`import_dit_lora` reads them back into live factors,
:func:`merge_lora_into_state_dict` folds them into the DiT's torch-layout
weights and :func:`split_finetuned_checkpoint` separates a training export
into its LoRA and ``pipe.*`` halves.
"""

from __future__ import annotations

import math
import re

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


# ---------------------------------------------------------------------------
# Reference-format LoRA files: pairs, the offline merge, the finetuned split,
# and the import into live factors
# ---------------------------------------------------------------------------

_LORA_RE = re.compile(r"^(.*)\.lora_([AB])(?:\.default)?\.weight$")


def collect_lora_pairs(lora_sd: dict) -> dict:
    """``{module_name: {"A": [r, in], "B": [out, r]}}`` (fp32 tensors) from a
    LoRA state dict; a leading ``diffusion_model.`` is stripped, as the
    reference's ``GeneralLoRALoader`` does, so community LoRA files load."""
    pairs: dict = {}
    for k, v in lora_sd.items():
        m = _LORA_RE.match(k)
        if m:
            name = m.group(1)
            if name.startswith("diffusion_model."):
                name = name[len("diffusion_model."):]
            pairs.setdefault(name, {})[m.group(2)] = torch.as_tensor(v).float()
    return {k: v for k, v in pairs.items() if "A" in v and "B" in v}


def merge_lora_into_state_dict(sd: dict, lora_sd: dict, alpha: float = 1.0,
                               dtype=None) -> dict:
    """``sd`` with ``weight += alpha * B @ A`` for every matched module, in
    fp32, on the weights' torch ``[out, in]`` layout, so one path serves
    every family.  Each merged weight is cast to ``dtype`` (the working
    dtype the load casts to anyway) as soon as it is made, so a 60-block DiT
    never holds all of them in fp32 at once; fp32 when ``dtype`` is None.
    Raises if a LoRA module has no weight in ``sd``."""
    pairs = collect_lora_pairs(lora_sd)
    missing = [n for n in pairs if n + ".weight" not in sd]
    if missing:
        raise KeyError(f"LoRA modules not found in base weights: {missing[:5]}...")
    out = dict(sd)
    for name, ab in pairs.items():
        w = torch.as_tensor(sd[name + ".weight"]).float()
        w = w + alpha * (ab["B"].to(w.device) @ ab["A"].to(w.device))
        out[name + ".weight"] = w if dtype is None else w.to(dtype)
    return out


def split_finetuned_checkpoint(sd: dict) -> tuple[dict, dict]:
    """A PhysicEdit training export -> (DiT LoRA keys, ``pipe.*`` keys with
    the prefix stripped); anything else is dropped with a warning, as the
    reference's validate script drops it."""
    import warnings

    lora_sd, pipe_sd, dropped = {}, {}, []
    for k, v in sd.items():
        if "lora_A" in k or "lora_B" in k:
            lora_sd[k] = v
        elif k.startswith("pipe."):
            pipe_sd[k[len("pipe."):]] = v
        else:
            dropped.append(k)
    if dropped:
        warnings.warn(f"finetuned checkpoint: dropped {len(dropped)} keys that are neither "
                      f"LoRA nor pipe.*; first: {dropped[:3]}", stacklevel=2)
    return lora_sd, pipe_sd


@torch.no_grad()
def import_dit_lora(lora_sd: dict, cfg, dtype=torch.float32, device="cuda") -> DiTLoRA:
    """A peft-format LoRA state dict (keys with or without ``pipe.dit.``) ->
    live factors for ``DiT.forward(lora=...)``, the inverse of
    :func:`export_dit_lora`."""
    pairs = collect_lora_pairs(lora_sd)

    def get(i, module):
        for cand in (f"transformer_blocks.{i}.{module}",
                     f"pipe.dit.transformer_blocks.{i}.{module}"):
            if cand in pairs:
                return pairs[cand]["A"].T, pairs[cand]["B"].T   # (in, r), (r, out)
        raise KeyError(f"missing LoRA for layer {i} module {module}")

    rank = next(iter(pairs.values()))["A"].shape[0]
    lora = materialize(DiTLoRA(cfg, rank, dtype), device)
    for name, modules in _FUSED.items():
        leaf = getattr(lora, name)
        for i in range(cfg.num_layers):
            for p, module in enumerate(modules):
                a, b = get(i, module)
                leaf.A[i, p].copy_(a)
                leaf.B[i, p].copy_(b)
    for name, module in _PLAIN.items():
        leaf = getattr(lora, name)
        for i in range(cfg.num_layers):
            a, b = get(i, module)
            leaf.A[i].copy_(a)
            leaf.B[i].copy_(b)
    return lora


# the DiT linear each factor name adapts, as attribute paths from a block
_TARGETS = {"img_qkv": ("attn", "img_qkv"), "txt_qkv": ("attn", "txt_qkv"),
            "to_out": ("attn", "to_out"), "to_add_out": ("attn", "to_add_out"),
            "img_mlp_fc2": ("img_mlp", "fc2"), "txt_mlp_fc2": ("txt_mlp", "fc2"),
            "img_mod": ("img_mod",), "txt_mod": ("txt_mod",)}


@torch.no_grad()
def merge_dit_lora_(dit, lora: DiTLoRA, alpha: float = 1.0):
    """Fold live factors into the DiT's float weights in place: W += alpha *
    (A @ B)^T, in fp32, cast back to W's dtype (the JAX package's
    ``_merge_lora_pytree``).  The fused QKV projections take their three
    parts' deltas on their row blocks.  Raises for a packed int4 layer:
    merge before ``quantize_``."""
    for i, block in enumerate(dit.blocks):
        for name, path in _TARGETS.items():
            lin = block
            for attr in path:
                lin = getattr(lin, attr)
            if not isinstance(lin, nn.Linear):
                raise ValueError(f"merge_dit_lora_: block {i} {name} is {type(lin).__name__}; "
                                 "merge the LoRA into the float DiT before quantize_")
            leaf = getattr(lora, name)
            delta = (leaf.A[i].float() @ leaf.B[i].float()) * alpha   # [(3,) in, out]
            if delta.dim() == 3:
                delta = delta.transpose(0, 1).reshape(delta.shape[1], -1)
            lin.weight.copy_((lin.weight.float() + delta.T.to(lin.weight.device))
                             .to(lin.weight.dtype))
    return dit
