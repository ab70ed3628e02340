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

from physicedit_torch.kernels.quant_matmul import W4Linear


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
def load_linear_(lin: nn.Module, p: dict) -> None:
    """Copy a JAX ``{"w": [in, out], "b": [out]}`` leaf into an ``nn.Linear``,
    or a packed-int4 ``{"w4": [in/2, out], "w_scale": [out], "b"}`` leaf into
    a :class:`W4Linear` (``w4``
    transposed to the port's ``[out, in/2]``, the bytes unchanged).

    The W8A8 leaves of the JAX package (``w_q``) belong to a lane that is
    not ported yet."""
    if "w_q" in p:
        raise NotImplementedError(
            "W8A8 linear leaves (w_q) are not ported; carry the float or "
            "packed-int4 weights instead")
    if isinstance(lin, W4Linear) != ("w4" in p):
        raise ValueError(f"a leaf with keys {sorted(p)} does not fit {type(lin).__name__}")
    if "w4" in p:
        w4 = np.asarray(p["w4"]).astype(np.int8)
        if w4.shape != (lin.in_features // 2, lin.out_features):
            raise ValueError(f"w4 leaf {w4.shape} does not fit "
                             f"[{lin.in_features // 2}, {lin.out_features}]")
        lin.w4.copy_(torch.from_numpy(np.ascontiguousarray(w4.T)))
        lin.w_scale.copy_(torch.from_numpy(np.array(p["w_scale"], np.float32)))
    else:
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
