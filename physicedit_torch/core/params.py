"""Linear layers, their random init, and loading of JAX parameter leaves.

Modules hold ``nn.Linear`` in torch's ``[out, in]`` layout (the JAX package
keeps ``[in, out]``).  Models are built on the ``meta`` device and then
materialised with :func:`materialize`, either with random weights drawn from
an explicit ``torch.Generator`` (:func:`init_random_`) or with weights
carried over from the JAX package (``io/from_jax.py``).  At full size that
is what lets the 20B DiT be created in bf16 directly on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class Leaf(nn.Module):
    """Named 1-D parameters of a JAX leaf dict such as ``{"scale": [d]}``
    (RMSNorm gains) or ``{"gamma": [c]}`` (the VAE channel norm)."""

    def __init__(self, dtype=None, device="meta", **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                   requires_grad=False))


def linear(d_in: int, d_out: int, bias: bool = True, dtype=None,
           device="meta") -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, dtype=dtype, device=device)


def materialize(module: nn.Module, device) -> nn.Module:
    """Allocate a ``meta``-built module on ``device`` (values undefined)."""
    module = module.to_empty(device=device)
    module.requires_grad_(False)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Torch-default init, the distribution of ``core/params.py::linear_init``
    in the JAX package: weights and biases uniform in +-1/sqrt(fan_in) for
    every ``nn.Linear`` and ``nn.Conv2d``, and every :class:`Leaf` gain set
    to one.  Parameters that are neither (embedding tables) are left to the
    caller."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Leaf):
            for p in m.parameters(recurse=False):
                p.fill_(1.0)
    return module


def _tensor(arr, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32)
                            ).to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def load_linear_(lin: nn.Linear, p: dict) -> None:
    """Copy a JAX ``{"w": [in, out], "b": [out]}`` leaf into ``lin``.

    The quantized leaves of the JAX package (``w_q`` for W8A8, ``w4`` for
    packed int4) belong to the quantized lane, which is not ported yet."""
    if "w_q" in p or "w4" in p:
        raise NotImplementedError(
            "quantized linear leaves (w_q / w4) are not ported; carry the "
            "bf16 or fp32 weights instead")
    w = np.asarray(p["w"], np.float32)
    if w.shape != (lin.in_features, lin.out_features):
        raise ValueError(f"linear leaf {w.shape} does not fit "
                         f"[{lin.in_features}, {lin.out_features}]")
    lin.weight.copy_(_tensor(w.T, lin.weight))
    if lin.bias is not None:
        lin.bias.copy_(_tensor(p["b"], lin.bias))
    elif "b" in p:
        raise ValueError("JAX leaf has a bias the module does not")


@torch.no_grad()
def load_conv_(conv: nn.Conv2d, p: dict) -> None:
    """Copy a JAX HWIO conv leaf into an OIHW ``nn.Conv2d``."""
    w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
    if w.shape != tuple(conv.weight.shape):
        raise ValueError(f"conv leaf {w.shape} does not fit {tuple(conv.weight.shape)}")
    conv.weight.copy_(_tensor(w, conv.weight))
    conv.bias.copy_(_tensor(p["b"], conv.bias))
