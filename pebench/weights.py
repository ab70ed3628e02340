"""Seeded random weights for the port's modules, made on the device.

A model's parameters are split into groups: everything up to and including
the first index of a module list (``blocks.7``), or else the first name
(``img_in``).  Each group has a generator of its own, seeded from the run's
seed and the group's name, and draws its tensors in the order of the
module's ``named_parameters``.  So any group can be drawn again, alone and
bit for bit, which is how the plain reference gets the very tensors the
program was given without keeping a second copy beside it.

The distribution is torch's default for linears and convolutions (uniform
in +-1 / sqrt(fan_in), biases alike), gains of one and LayerNorm biases of
zero on 1-D norm leaves, and N(0, 0.02^2) for every other tensor (token
tables, learned latents).  A configuration may set other gains by the end
of a leaf's name (``gains``): the DiT's q / k RMSNorm gains set how peaked
its attention is.
"""

from __future__ import annotations

import hashlib
import math

import torch
from torch import nn


def mix(seed: int, *names) -> int:
    """A 63-bit generator seed from the run's seed and a path of names."""
    key = "/".join([str(int(seed))] + [str(n) for n in names]).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") & ((1 << 63) - 1)


def group_of(name: str) -> str:
    parts = name.split(".")
    for i, p in enumerate(parts[:-1]):
        if p.isdigit():
            return ".".join(parts[:i + 1])
    return parts[0]


def specs(module: nn.Module, gains: dict | None = None) -> list:
    """``(name, shape, kind, arg)`` for every parameter, in
    ``named_parameters`` order (``arg``: the fan-in of a ``uniform`` leaf,
    the value of a ``fill``); ``module`` may live on ``meta``.  A gain leaf
    whose name ends with a key of ``gains`` is filled with its value."""
    gains = gains or {}
    kinds = {}
    for mname, m in module.named_modules():
        direct = dict(m.named_parameters(recurse=False))
        for pname, p in direct.items():
            full = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d,
                              nn.ConvTranspose2d)) and pname in ("weight", "bias"):
                kinds[full] = ("uniform", m.weight[0].numel())
            elif p.dim() == 1 and pname == "bias":
                kinds[full] = ("zeros", 0)
            elif p.dim() == 1:
                fill = [v for k, v in gains.items() if full.endswith(k)]
                kinds[full] = ("fill", fill[0]) if fill else ("ones", 0)
            else:
                kinds[full] = ("normal", 0)
    return [(n, tuple(p.shape), *kinds[n]) for n, p in module.named_parameters()]


@torch.no_grad()
def draw_group(spec_list: list, seed: int, model: str, group: str, device,
               dtype=torch.bfloat16) -> dict:
    """The tensors of one group, ``{name: tensor}``, drawn anew."""
    gen = torch.Generator(device).manual_seed(mix(seed, model, group))
    out = {}
    for name, shape, kind, arg in spec_list:
        if group_of(name) != group:
            continue
        t = torch.empty(shape, dtype=dtype, device=device)
        if kind == "uniform":
            bound = 1.0 / math.sqrt(arg)
            t.uniform_(-bound, bound, generator=gen)
        elif kind == "zeros":
            t.zero_()
        elif kind == "ones":
            t.fill_(1.0)
        elif kind == "fill":
            t.fill_(float(arg))
        else:
            t.normal_(0.0, 0.02, generator=gen)
        out[name] = t
    return out


def groups(spec_list: list) -> list:
    seen = {}
    for name, *_ in spec_list:
        seen.setdefault(group_of(name), None)
    return list(seen)


class ModelWeights:
    """The weights of one model of a run: its parameter specs, and every
    group drawable again from ``(seed, model, group)``."""

    def __init__(self, model: str, module: nn.Module, seed: int, device,
                 dtype=torch.bfloat16, gains: dict | None = None):
        self.model, self.seed, self.device, self.dtype = model, seed, device, dtype
        self.specs = specs(module, gains)

    def group(self, group: str) -> dict:
        return draw_group(self.specs, self.seed, self.model, group, self.device, self.dtype)

    def load_into(self, module: nn.Module) -> nn.Module:
        """Draw every group and hand the tensors to ``module`` (built on
        ``meta``) by their state-dict keys; nothing is copied."""
        state = {}
        for g in groups(self.specs):
            state.update(self.group(g))
        module.load_state_dict(state, strict=True, assign=True)
        return module.requires_grad_(False).eval()
