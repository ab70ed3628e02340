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
from physicedit_torch.ops.quant import Int8Linear


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
    to one (a LayerNorm's ``bias`` to zero).  Parameters that are neither
    (embedding tables) are left to the caller.  Convolutions of every kind
    (``nn.Conv3d``, ``nn.ConvTranspose2d``) take the same rule, their fan-in
    that of torch's default init."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Leaf):
            for name, p in m.named_parameters(recurse=False):
                p.fill_(0.0 if name == "bias" else 1.0)
    return module


def linear_promoted(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` in the promoted dtype of x and the layer, as
    ``jnp.matmul`` promotes a bf16 activation against fp32 weights (an
    ``nn.Linear`` would raise on the mixed dtypes)."""
    dt = torch.promote_types(x.dtype, lin.weight.dtype)
    return nn.functional.linear(x.to(dt), lin.weight.to(dt),
                                None if lin.bias is None else lin.bias.to(dt))


def _tensor(arr, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32)
                            ).to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def load_linear_(lin: nn.Module, p: dict) -> None:
    """Copy a JAX ``{"w": [in, out], "b": [out]}`` leaf into an ``nn.Linear``,
    a packed-int4 ``{"w4": [in/2, out], "w_scale": [out], "b"}`` leaf into
    a :class:`W4Linear` (``w4`` transposed to the port's ``[out, in/2]``, the
    bytes unchanged), or a W8A8 ``{"w_q": [in, out], "w_scale": [out], "b"}``
    leaf into an :class:`Int8Linear` (``w_q`` transposed to ``[out, in]``)."""
    kind = "w4" if "w4" in p else "w_q" if "w_q" in p else "w"
    want = {"w4": W4Linear, "w_q": Int8Linear, "w": nn.Linear}[kind]
    if not isinstance(lin, want):
        raise ValueError(f"a leaf with keys {sorted(p)} does not fit {type(lin).__name__}")
    if kind == "w4":
        w4 = np.asarray(p["w4"]).astype(np.int8)
        if w4.shape != (lin.in_features // 2, lin.out_features):
            raise ValueError(f"w4 leaf {w4.shape} does not fit "
                             f"[{lin.in_features // 2}, {lin.out_features}]")
        lin.w4.copy_(torch.from_numpy(np.ascontiguousarray(w4.T)))
        lin.w_scale.copy_(torch.from_numpy(np.array(p["w_scale"], np.float32)))
    elif kind == "w_q":
        w_q = np.asarray(p["w_q"]).astype(np.int8)
        if w_q.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"w_q leaf {w_q.shape} does not fit "
                             f"[{lin.in_features}, {lin.out_features}]")
        lin.w_q.copy_(torch.from_numpy(np.ascontiguousarray(w_q.T)))
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
def load_conv_(conv: nn.Module, p: dict) -> None:
    """Copy a JAX conv leaf into a torch conv: HWIO into an OIHW
    ``nn.Conv2d``, DHWIO into an OIDHW ``nn.Conv3d``, and the HWIO kernel
    that JAX applies with ``transpose_kernel=True`` (``[kH, kW, C_out,
    C_in]``) into an ``nn.ConvTranspose2d``'s ``[C_in, C_out, kH, kW]``."""
    w = np.asarray(p["w"], np.float32)
    w = w.transpose((4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1))
    if w.shape != tuple(conv.weight.shape):
        raise ValueError(f"conv leaf {w.shape} does not fit {tuple(conv.weight.shape)}")
    conv.weight.copy_(_tensor(w, conv.weight))
    if conv.bias is not None:
        conv.bias.copy_(_tensor(p["b"], conv.bias))
