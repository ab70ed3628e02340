"""Carry the JAX package's parameter trees into this package's modules.

A JAX tree is a nest of dicts (and lists) whose leaves are arrays; NumPy
arrays or anything ``np.asarray`` accepts.  The port's modules name their
children after the tree's keys, so one walk loads any model:

- ``{"w": [in, out], "b"}`` -> ``nn.Linear`` (transposed to ``[out, in]``),
- ``{"w4": [in/2, out], "w_scale", "b"}`` -> ``W4Linear`` (the packed int4
  lane; it takes the ``nn.Linear``'s place),
- ``{"w": HWIO, "b"}`` -> ``nn.Conv2d`` (to OIHW),
- stacked layer trees (leaves ``[L, ...]`` under ``blocks`` / ``layers``)
  -> ``nn.ModuleList`` (unstacked),
- any other array -> the parameter of that name.

Every parameter and buffer of the module must be covered by the tree.  The
text model takes the layout of its tree first: fused ``qkv`` / ``gate_up``
projections and the int8 embedding table (``{"e8", "e_scale"}``) of the
quantized lane.  The configs are rebuilt from the JAX config dataclasses by
field name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from physicedit_torch.core.params import load_conv_, load_linear_, materialize
from physicedit_torch.kernels.quant_matmul import W4Linear
from physicedit_torch.models.adapters import DualAdapter
from physicedit_torch.models.dit import DiT, DiTConfig
from physicedit_torch.models.qwen_vl import (Int8Embedding, QwenVLText, QwenVLTextConfig,
                                             fuse_decode_projections)
from physicedit_torch.models.qwen_vl_vision import QwenVLVision, QwenVLVisionConfig
from physicedit_torch.models.vae import VAE, VAEConfig


def config_from_jax(cfg, cls):
    """A port config from the JAX config dataclass of the same fields."""
    return cls(**dataclasses.asdict(cfg))


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


@torch.no_grad()
def load_tree_(module: nn.Module, tree: dict) -> int:
    """Copy ``tree`` into ``module`` by name; returns the parameters set."""
    n = 0
    for key, val in tree.items():
        target = getattr(module, key)
        if isinstance(target, nn.ModuleList):
            subs = ([_index(val, i) for i in range(len(target))]
                    if isinstance(val, dict) else list(val))
            if len(subs) != len(target):
                raise ValueError(f"{key}: {len(subs)} entries for {len(target)} modules")
            n += sum(load_tree_(m, t) for m, t in zip(target, subs))
        elif isinstance(target, (nn.Linear, W4Linear)):
            if "w4" in val and isinstance(target, nn.Linear):
                target = W4Linear(target.in_features, target.out_features,
                                  bias=target.bias is not None, dtype=target.weight.dtype,
                                  device=target.weight.device)
                setattr(module, key, target)
            load_linear_(target, val)
            n += 1 + isinstance(target, W4Linear) + (target.bias is not None)
        elif isinstance(target, nn.Conv2d):
            load_conv_(target, val)
            n += 2
        elif isinstance(target, torch.Tensor):      # a parameter or a buffer
            arr = np.asarray(val)
            arr = arr.astype(np.int8 if target.dtype == torch.int8 else np.float32)
            if arr.shape != tuple(target.shape):
                raise ValueError(f"{key}: {arr.shape} != {tuple(target.shape)}")
            target.copy_(torch.from_numpy(arr).to(target.device, target.dtype))
            n += 1
        else:
            n += load_tree_(target, val)
    return n


def _carry(module: nn.Module, tree: dict, device, prepare=None) -> nn.Module:
    module = materialize(module, device)
    if prepare is not None:
        prepare(module)
    n = load_tree_(module, tree)
    expected = len(list(module.parameters())) + len(list(module.buffers()))
    if n != expected:
        raise ValueError(f"{type(module).__name__}: the tree set {n} of "
                         f"{expected} parameters and buffers")
    return module.eval()


def dit_from_jax(params: dict, cfg, dtype=torch.float32, device="cpu") -> DiT:
    return _carry(DiT(config_from_jax(cfg, DiTConfig), dtype), params, device)


def vae_from_jax(params: dict, cfg, dtype=torch.float32, device="cpu") -> VAE:
    return _carry(VAE(config_from_jax(cfg, VAEConfig), dtype), params, device)


def text_from_jax(params: dict, cfg, dtype=torch.float32, device="cpu") -> QwenVLText:
    layers = params["layers"]
    first = layers[0] if isinstance(layers, (list, tuple)) else layers

    def prepare(text):
        # give the module the layout of the tree; the values are loaded next
        if "qkv" in first or "gate_up" in first["mlp"]:
            fuse_decode_projections(text)
        if isinstance(params["embed"], dict):
            dev = text.norm.scale.device
            del text.embed
            text.embed = Int8Embedding(
                torch.empty(np.shape(params["embed"]["e8"]), dtype=torch.int8, device=dev),
                torch.empty(np.shape(params["embed"]["e_scale"]), dtype=torch.bfloat16,
                            device=dev))

    return _carry(QwenVLText(config_from_jax(cfg, QwenVLTextConfig), dtype),
                  params, device, prepare)


def vision_from_jax(params: dict, cfg, dtype=torch.float32,
                    device="cpu") -> QwenVLVision:
    return _carry(QwenVLVision(config_from_jax(cfg, QwenVLVisionConfig), dtype),
                  params, device)


def dual_adapter_from_jax(params: dict, dtype=torch.float32,
                          device="cpu") -> DualAdapter:
    fc1 = np.asarray(params["head_dino"]["fc1"]["w"])
    fc2 = np.asarray(params["head_dino"]["fc2"]["w"])
    return _carry(DualAdapter(fc1.shape[0], fc2.shape[1], dtype), params, device)


def pipeline_from_jax(jpipe, device="cpu"):
    """The port's pipeline with the weights, configs, tokenizer and token ids
    of a JAX ``PhysicEditPipeline`` (single-image edit path only)."""
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    dtype = getattr(torch, np.dtype(jpipe.dtype).name)
    adapter = jpipe.adapters.get("visual_thinking_adapter")
    return PhysicEditPipeline(
        dit=dit_from_jax(jpipe.dit_params, jpipe.dit_cfg, dtype, device),
        vae=vae_from_jax(jpipe.vae_params, jpipe.vae_cfg, dtype, device),
        text=text_from_jax(jpipe.text_params, jpipe.text_cfg, dtype, device),
        vision=vision_from_jax(jpipe.vision_params, jpipe.vision_cfg, dtype, device),
        adapter=None if adapter is None else dual_adapter_from_jax(adapter, dtype, device),
        tokenizer=jpipe.tokenizer, dtype=dtype, device=device,
        boi_token_id=jpipe.boi_token_id, eoi_token_id=jpipe.eoi_token_id,
        image_pad_id=jpipe.image_pad_id, vision_start_id=jpipe.vision_start_id,
        edit_drop_idx=jpipe.edit_drop_idx, rope_axes=tuple(jpipe.rope_axes),
        txt_len_bucket=jpipe.txt_len_bucket, kv_int8=jpipe.kv_int8)
