"""The mesh, the partition specs and tensor parallelism
(``physicedit_tpu/parallel/sharding.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices with two
axes, ``data`` (batch parallel, the reference's DDP) and ``model`` (tensor
parallel: Megatron column / row splits of the DiT's and the VL text model's
projections), and lets GSPMD place the collectives.  The port is
multi-process SPMD, one process per GPU under ``torchrun``: the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names, each
process keeps only its own slice of a split weight, and the split layers
call the collectives of ``parallel/comm.py`` themselves.

A spec is a :class:`Split` or None (replicated) per parameter name.  The
port's ``nn.Linear`` weight is ``[out, in]``, per block, where the JAX leaf
is ``[L, in, out]``: JAX's column split ``P(None, None, "model")`` is the
port's ``Split(0)``, its row split ``P(None, "model", None)`` the port's
``Split(1)``.  A fused projection (the DiT's ``img_qkv`` / ``txt_qkv``,
viewed as ``(3, heads, head_dim)``) splits each of its parts alone, by whole
heads; JAX splits the concatenated output evenly and lets GSPMD reshard.
Splits that share a ``group`` (one block's attention, one MLP) stand or
fall together: where the group's heads or features do not divide over the
axis (the VL's 4 KV heads at tp 8), the group's weights stay whole on every
rank and that part runs replicated (deviation D3 in ROADMAP.md: more
memory than JAX's reshard, the same result).

:func:`shard_params` keeps this rank's slice of each split weight in place
of the whole one and swaps the layer for a :class:`TPLinear`, which runs
the slice with the collective its split needs: a column split's input goes
through ``copy_to`` (its gradient is all-reduced), a row split's output
through ``reduce_from`` before its bias is added, and a column split marked
``gather`` (the DiT's modulation, whose six chunks every rank needs) is
all-gathered.  LoRA factors stay replicated; :func:`lora_delta_tp` gives a
split layer's delta on its slice, equal to the unsharded one, with
gradients whole on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from physicedit_torch.parallel import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(n_data: int, n_model: int, device: str = "cuda"):
    """A ``DeviceMesh`` of shape (n_data, n_model) with axes (``data``,
    ``model``) over the processes of the default group, rank-major: ranks
    ``d * n_model .. d * n_model + n_model - 1`` form data row d's model
    group.  The world size must be ``n_data * n_model`` (one process per
    device, where the JAX mesh takes the first devices of one process).
    With no process group yet and a mesh of one, a world of one is started
    on a local store (NCCL on CUDA, Gloo on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_data * n_model
    dev_type = torch.device(device).type
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {n_data}x{n_model} mesh needs {n} processes: start them "
                               f"with torchrun and call multihost.initialize_distributed")
        dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {n_data}x{n_model} mesh needs {n} processes, the world has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(dev_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class Split:
    """How one weight splits over the model axis.

    dim: 0 splits the output features (JAX's column split), 1 the input
    features (its row split).  parts: a fused projection's equal blocks
    along ``dim``, each split alone.  unit: split only in whole units (a
    head's width).  group: splits that stand or fall together.  gather: a
    column split whose output is all-gathered."""
    dim: int
    parts: int = 1
    unit: int = 1
    group: str = ""
    gather: bool = False


def _linear_specs(specs: dict, prefix: str, lin: nn.Module, split: Split) -> None:
    specs[f"{prefix}.weight"] = split
    if getattr(lin, "bias", None) is not None:
        # a column split's bias splits with its outputs; a row split's is whole
        specs[f"{prefix}.bias"] = split if split.dim == 0 else None


def _replicated(module: nn.Module) -> dict:
    return {name: None for name, _ in module.named_parameters()}


def dit_param_specs(dit: nn.Module) -> dict:
    """The DiT's specs (JAX ``dit_param_specs``): per block ``img_mod`` /
    ``txt_mod``, the fused ``img_qkv`` / ``txt_qkv`` and both MLPs' ``fc1``
    column-split, ``to_out`` / ``to_add_out`` and both ``fc2`` row-split;
    everything else replicated."""
    specs = _replicated(dit)
    hd = dit.cfg.head_dim
    for i, blk in enumerate(dit.blocks):
        p = f"blocks.{i}"
        for name in ("img_mod", "txt_mod"):
            _linear_specs(specs, f"{p}.{name}", getattr(blk, name),
                          Split(0, group=f"{p}.{name}", gather=True))
        attn = f"{p}.attn"
        for name in ("img_qkv", "txt_qkv"):
            _linear_specs(specs, f"{attn}.{name}", blk.attn[name],
                          Split(0, parts=3, unit=hd, group=attn))
        for name in ("to_out", "to_add_out"):
            _linear_specs(specs, f"{attn}.{name}", blk.attn[name], Split(1, unit=hd, group=attn))
        for name in ("img_mlp", "txt_mlp"):
            mlp = getattr(blk, name)
            _linear_specs(specs, f"{p}.{name}.fc1", mlp["fc1"], Split(0, group=f"{p}.{name}"))
            _linear_specs(specs, f"{p}.{name}.fc2", mlp["fc2"], Split(1, group=f"{p}.{name}"))
    return specs


def qwen_vl_text_param_specs(text: nn.Module) -> dict:
    """The VL text model's specs (JAX ``qwen_vl_text_param_specs``): per
    layer q / k / v (by whole heads), gate and up column-split, o and down
    row-split, ``lm_head`` column-split (its logits all-gathered);
    embeddings and norms replicated."""
    specs = _replicated(text)
    hd = text.cfg.head_dim
    for i, layer in enumerate(text.layers):
        p = f"layers.{i}"
        for name in ("q", "k", "v"):
            _linear_specs(specs, f"{p}.{name}", getattr(layer, name),
                          Split(0, unit=hd, group=f"{p}.attn"))
        _linear_specs(specs, f"{p}.o", layer.o, Split(1, unit=hd, group=f"{p}.attn"))
        for name in ("gate", "up"):
            _linear_specs(specs, f"{p}.mlp.{name}", layer.mlp[name], Split(0, group=f"{p}.mlp"))
        _linear_specs(specs, f"{p}.mlp.down", layer.mlp["down"], Split(1, group=f"{p}.mlp"))
    _linear_specs(specs, "lm_head", text.lm_head, Split(0, group="lm_head", gather=True))
    return specs


def batch_specs():
    """Activations: the batch on ``data``, the rest replicated (JAX
    ``batch_specs``, ``P("data")``); here the name of the axis that slices
    the leading dim (``multihost.host_local_batch_slice``)."""
    return DATA_AXIS


def splits_evenly(shape, split: Split, size: int) -> bool:
    n = shape[split.dim]
    return n % split.parts == 0 and (n // split.parts) % (size * split.unit) == 0


def shard_tensor(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` (of ``size``), contiguous: along
    ``split.dim``, each of ``split.parts`` blocks cut into ``size`` pieces."""
    dim = split.dim
    blocks = t.shape[dim] // split.parts
    piece = blocks // size
    idx = torch.cat([torch.arange(p * blocks + rank * piece, p * blocks + (rank + 1) * piece)
                     for p in range(split.parts)]).to(t.device)
    return t.index_select(dim, idx).contiguous()


def unshard_tensor(shards: list, split: Split) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the ranks' slices, in rank
    order, put back together."""
    dim = split.dim
    blocks = [t.movedim(dim, 0).reshape(split.parts, -1, *t.movedim(dim, 0).shape[1:])
              for t in shards]
    whole = torch.cat(blocks, dim=1)
    return whole.reshape(-1, *whole.shape[2:]).movedim(0, dim)


class TPLinear(nn.Module):
    """This rank's slice of a split ``nn.Linear`` and the collective its
    split needs (see the module docstring).  ``in_features`` /
    ``out_features`` are the slice's."""

    def __init__(self, split: Split, group, weight: torch.Tensor, bias: torch.Tensor | None):
        super().__init__()
        self.split, self.group = split, group
        self.out_features, self.in_features = weight.shape
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split.dim == 0:
            y = F.linear(comm.copy_to(x, self.group), self.weight, self.bias)
            return comm.gather(y, -1, self.group) if self.split.gather else y
        y = comm.reduce_from(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def whole_groups(module: nn.Module, specs: dict, size: int) -> set:
    """The groups that cannot split over ``size`` ranks: some member's
    features do not divide into whole units."""
    params = dict(module.named_parameters())
    return {s.group for name, s in specs.items()
            if s is not None and name.endswith(".weight")
            and not splits_evenly(params[name].shape, s, size)}


@torch.no_grad()
def shard_params(module: nn.Module, specs: dict, mesh, axis: str = MODEL_AXIS) -> nn.Module:
    """Keep this rank's slice of every split ``nn.Linear`` of ``module``,
    in place: each becomes a :class:`TPLinear` holding only its slice (the
    whole weight is freed once nothing else refers to it).  Replicated
    parameters stay as they are, as does every split of a group that does
    not divide over the axis (D3).  A mesh axis of one changes nothing.
    Returns ``module``."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size == 1:
        return module
    group, rank = mesh.get_group(axis), mesh.get_local_rank(axis)
    whole = whole_groups(module, specs, size)
    for name, split in specs.items():
        if split is None or not name.endswith(".weight") or split.group in whole:
            continue
        path = name[: -len(".weight")]
        parent_name, _, child = path.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        lin = parent._modules[child]
        if isinstance(lin, TPLinear):       # split already
            continue
        if not isinstance(lin, nn.Linear):
            raise ValueError(f"shard_params: {path} is a {type(lin).__name__}; only float "
                             f"nn.Linear layers split")
        bias = lin.bias
        if bias is not None and specs.get(f"{path}.bias") is not None:
            bias = shard_tensor(bias, split, rank, size)
        parent._modules[child] = TPLinear(split, group,
                                          shard_tensor(lin.weight, split, rank, size),
                                          None if bias is None else bias.detach())
    return module


def lora_delta_tp(lin: nn.Module, leaf: dict, x: torch.Tensor, fused: bool) -> torch.Tensor:
    """The LoRA delta of ``leaf`` for ``lin``'s output, on ``lin``'s slice
    when ``lin`` is a :class:`TPLinear`, else the plain delta.

    Column split (only the fused QKV takes LoRA): ``copy_to(x @ A) @
    scatter(B)``, this rank's heads of each part.  Row split (``to_out``, ``fc2``):
    ``reduce_from(x_local @ scatter(A)) @ B``.  The factors stay whole; the
    scatters' backward all-gathers their gradients and the conjugate pair
    makes the rest whole, so every rank holds the unsharded gradients.
    A gathered column split's output is already whole (the modulation)."""
    from physicedit_torch.lora import _promote, lora_delta, lora_delta_fused

    if not isinstance(lin, TPLinear) or lin.split.gather:
        return lora_delta_fused(leaf, x) if fused else lora_delta(leaf, x)
    g = lin.group
    x, a, b = _promote(x, leaf["A"], leaf["B"])
    if lin.split.dim == 1:
        return comm.reduce_from(x @ comm.scatter(a, 0, g), g) @ b
    if not fused:
        raise ValueError("a column-split layer takes LoRA only as the fused QKV's")
    t = comm.copy_to(torch.einsum("bsi,pir->bspr", x, a), g)
    d = torch.einsum("bspr,pro->bspo", t, comm.scatter(b, -1, g))
    return d.reshape(x.shape[0], x.shape[1], -1)
