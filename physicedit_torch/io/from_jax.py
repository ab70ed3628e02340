"""Carry the JAX package's parameter trees into this package's modules.

A JAX tree is a nest of dicts (and lists) whose leaves are arrays; NumPy
arrays or anything ``np.asarray`` accepts.  The port's modules name their
children after the tree's keys, so one walk loads any model:

- ``{"w": [in, out], "b"}`` -> ``nn.Linear`` (transposed to ``[out, in]``),
- ``{"w4": [in/2, out], "w_scale", "b"}`` -> ``W4Linear`` (the packed int4
  lane; it takes the ``nn.Linear``'s place),
- ``{"w_q": [in, out], "w_scale", "b"}`` -> ``Int8Linear`` (the W8A8 lane,
  ``ops/quant.py``; likewise),
- ``{"w": HWIO, "b"}`` (``b`` absent for a bias-free conv) -> ``nn.Conv2d``
  (to OIHW), ``{"w": DHWIO, "b"}`` ->
  ``nn.Conv3d`` (to OIDHW), and the HWIO kernel JAX applies with
  ``transpose_kernel=True`` -> ``nn.ConvTranspose2d`` (``[C_in, C_out, kH,
  kW]``); any other key of a conv leaf (RIFE's PReLU slope ``a``) -> the
  conv module's parameter of that name,
- a list, or a stacked tree (leaves ``[L, ...]``, as the DiT's ``blocks``,
  the text model's ``layers`` or ESRGAN's ``body``), under any
  ``nn.ModuleList`` -> its modules (unstacked),
- any other array -> the parameter of that name.

Every parameter and buffer of the module must be covered by the tree.  The
text model takes the layout of its tree first: fused ``qkv`` / ``gate_up``
projections and the int8 embedding table (``{"e8", "e_scale"}``) of the
quantized lane.  The configs are rebuilt from the JAX config dataclasses by
field name.

The training surface comes across the same way (the LoRA tree, the
adapters, DINOv2), as do the prompt refiners' BLOOM and Marian, the quality
scorers' OpenCLIP and ImageReward towers, and Nexus-Gen with its merger and
adapter, and
:func:`to_jax_tree` walks back: a module's parameters, or their gradients,
as a JAX-layout tree, for the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from physicedit_torch.core.params import load_conv_, load_linear_, materialize
from physicedit_torch.kernels.quant_matmul import W4Linear
from physicedit_torch.lora import DiTLoRA
from physicedit_torch.models.adapters import DualAdapter
from physicedit_torch.models.controlnet import BlockwiseControlNet
from physicedit_torch.models.dinov2 import DinoV2, DinoV2Config
from physicedit_torch.models.dit import DiT, DiTConfig
from physicedit_torch.models.qwen_vl import (Int8Embedding, QwenVLText, QwenVLTextConfig,
                                             fuse_decode_projections)
from physicedit_torch.models.qwen_vl_vision import QwenVLVision, QwenVLVisionConfig
from physicedit_torch.models.vae import VAE, VAEConfig
from physicedit_torch.ops.quant import Int8Linear


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
    return sum(_load(module, key, getattr(module, key), val) for key, val in tree.items())


def _load(parent: nn.Module, key: str, target, val) -> int:
    if isinstance(target, nn.ModuleList):
        subs = ([_index(val, i) for i in range(len(target))]
                if isinstance(val, dict) else list(val))
        if len(subs) != len(target):
            raise ValueError(f"{key}: {len(subs)} entries for {len(target)} modules")
        return sum(_load(target, str(i), m, t) for i, (m, t) in enumerate(zip(target, subs)))
    if isinstance(target, (nn.Linear, W4Linear, Int8Linear)):
        quantized = W4Linear if "w4" in val else Int8Linear if "w_q" in val else None
        if quantized is not None and isinstance(target, nn.Linear):
            target = quantized(target.in_features, target.out_features,
                               bias=target.bias is not None, dtype=target.weight.dtype,
                               device=target.weight.device)
            setattr(parent, key, target)
        load_linear_(target, val)
        return 1 + (not isinstance(target, nn.Linear)) + (target.bias is not None)
    if isinstance(target, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
        load_conv_(target, val)
        return 1 + (target.bias is not None) + load_tree_(
            target, {k: v for k, v in val.items() if k not in ("w", "b")})
    if isinstance(target, torch.Tensor):      # a parameter or a buffer
        arr = np.asarray(val)
        arr = arr.astype(np.int8 if target.dtype == torch.int8 else np.float32)
        if arr.shape != tuple(target.shape):
            raise ValueError(f"{key}: {arr.shape} != {tuple(target.shape)}")
        target.copy_(torch.from_numpy(arr).to(target.device, target.dtype))
        return 1
    return load_tree_(target, val)


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


def dit_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda") -> DiT:
    return _carry(DiT(config_from_jax(cfg, DiTConfig), dtype), params, device)


def vae_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda") -> VAE:
    return _carry(VAE(config_from_jax(cfg, VAEConfig), dtype), params, device)


def vae3d_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``vae_video_from_torch`` tree -> ``models.vae3d.VideoVAE``."""
    from physicedit_torch.models.vae3d import VideoVAE

    return _carry(VideoVAE(config_from_jax(cfg, VAEConfig), dtype), params, device)


def text_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda") -> QwenVLText:
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
                    device="cuda") -> QwenVLVision:
    return _carry(QwenVLVision(config_from_jax(cfg, QwenVLVisionConfig), dtype),
                  params, device)


def dual_adapter_from_jax(params: dict, dtype=torch.float32,
                          device="cuda") -> DualAdapter:
    fc1 = np.asarray(params["head_dino"]["fc1"]["w"])
    fc2 = np.asarray(params["head_dino"]["fc2"]["w"])
    return _carry(DualAdapter(fc1.shape[0], fc2.shape[1], dtype), params, device)


def controlnet_from_jax(params: dict, dtype=torch.float32,
                        device="cuda") -> BlockwiseControlNet:
    """A JAX ``init_controlnet_params`` / ``controlnet_from_torch`` tree."""
    in_dim, dim = np.shape(params["img_in"]["w"])
    layers = np.shape(params["blocks"]["input_proj"]["w"])[0]
    return _carry(BlockwiseControlNet(layers, in_dim, 0, dim, dtype), params, device)


def dinov2_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda") -> DinoV2:
    n0 = np.shape(params["pos_emb"])[1] - 1
    grid = int(round(float(np.sqrt(n0))))
    return _carry(DinoV2(config_from_jax(cfg, DinoV2Config), grid, dtype), params, device)


def lora_from_jax(tree: dict, cfg, dtype=torch.float32, device="cuda") -> DiTLoRA:
    """A JAX ``init_dit_lora`` tree -> ``DiTLoRA`` (trainable)."""
    rank = np.shape(tree["to_out"]["A"])[-1]
    return _carry(DiTLoRA(config_from_jax(cfg, DiTConfig), rank, dtype), tree,
                  device).requires_grad_(True)


def trainable_from_jax(trainable: dict, dit_cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``{"lora", "adapters"}`` trainable tree -> the port's
    ``train.trainer.Trainable`` (all parameters trainable)."""
    from physicedit_torch.train.trainer import Trainable, TrainingAdapters

    ad = trainable["adapters"]
    adapters = _carry(TrainingAdapters(np.shape(ad["visual_thinking_adapter"]["head_dino"]
                                                ["fc2"]["w"])[1],
                                       np.shape(ad["dino_time_embed"])[1],
                                       np.shape(ad["vae_time_embed"])[1], dtype), ad, device)
    return Trainable(lora_from_jax(trainable["lora"], dit_cfg, dtype, device),
                     adapters).requires_grad_(True)


def bloom_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``models/bloom.py`` tree (``bloom_from_torch``) -> ``Bloom``."""
    from physicedit_torch.models.bloom import Bloom, BloomConfig

    return _carry(Bloom(config_from_jax(cfg, BloomConfig), dtype), params, device)


def marian_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``models/marian.py`` tree (``marian_from_torch``) -> ``Marian``."""
    from physicedit_torch.models.marian import Marian, MarianConfig

    return _carry(Marian(config_from_jax(cfg, MarianConfig), dtype), params, device)


def esrgan_from_jax(params: dict, device="cuda"):
    """A JAX ``esrgan_from_torch`` / ``init_esrgan_params`` tree (``body``
    stacked) -> ``extensions.esrgan.RRDBNet`` in fp32."""
    from physicedit_torch.extensions.esrgan import RRDBNet

    first, body = params["conv_first"]["w"], params["body"]["rdb1"]["conv1"]["w"]
    net = RRDBNet(np.shape(first)[2], np.shape(params["conv_last"]["w"])[3],
                  np.shape(first)[3], np.shape(body)[0], np.shape(body)[4])
    return _carry(net, params, device)


def ifnet_from_jax(params: dict, device="cuda"):
    """A JAX ``ifnet_from_torch`` / ``init_ifnet_params`` tree ->
    ``extensions.rife.IFNet`` in fp32."""
    from physicedit_torch.extensions.rife import IFNet

    conv0 = params["block0"]["conv0"]
    return _carry(IFNet(np.shape(conv0[1]["w"])[3], np.shape(conv0[0]["w"])[2]), params,
                  device)


def openclip_from_jax(params: dict, vision_cfg, text_cfg, dtype=torch.float32,
                      device="cuda"):
    """A JAX ``openclip_from_state_dict`` tree and its two configs ->
    ``models.openclip.OpenClip`` (the widths the JAX configs leave to the
    shapes read from the tree)."""
    from physicedit_torch.models.openclip import OpenClip, OpenClipTowerConfig

    v, t = params["visual"], params["text"]

    def cfg(jcfg, tower, proj, **kw):
        return dataclasses.replace(
            config_from_jax(jcfg, OpenClipTowerConfig), output_dim=np.shape(tower[proj])[1],
            mlp_ratio=np.shape(tower["blocks"]["c_fc"]["w"])[-1] // jcfg.width, **kw)

    n_pos = np.shape(v["positional_embedding"])[0]
    vcfg = cfg(vision_cfg, v, "proj",
               image_size=int(round((n_pos - 1) ** 0.5)) * vision_cfg.patch_size)
    tcfg = cfg(text_cfg, t, "text_projection")
    tree = {"visual": {**v, "conv1": {"w": v["conv1"]}}, "text": t}
    return _carry(OpenClip(vcfg, tcfg, np.shape(t["token_embedding"])[0], dtype), tree, device)


def imagereward_from_jax(params: dict, vit_cfg, txt_cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``imagereward_from_state_dict`` tree -> ``models.blip.ImageReward``."""
    from physicedit_torch.models.blip import BlipTextConfig, BlipViTConfig, ImageReward

    dims = [np.shape(params["mlp"][0]["w"])[0]] + [np.shape(p["w"])[1] for p in params["mlp"]]
    return _carry(ImageReward(config_from_jax(vit_cfg, BlipViTConfig),
                              config_from_jax(txt_cfg, BlipTextConfig), tuple(dims), dtype),
                  params, device)


def nexus_gen_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``init_nexus_params`` / ``nexus_llm_from_torch`` tree ->
    ``models.nexus_gen.NexusGen``."""
    from physicedit_torch.models.nexus_gen import NexusGen

    return _carry(NexusGen(config_from_jax(cfg, QwenVLTextConfig), dtype), params, device)


def merger_from_jax(params: dict, cfg, dtype=torch.float32, device="cuda"):
    """A JAX ``init_merger_params`` / ``merger_from_torch`` tree and its JAX
    text config -> ``models.nexus_gen_projector.NexusGenImageEmbeddingMerger``."""
    from physicedit_torch.models.nexus_gen_projector import NexusGenImageEmbeddingMerger

    mid, out = np.shape(params["proj"]["fc2"]["w"])
    return _carry(NexusGenImageEmbeddingMerger(config_from_jax(cfg, QwenVLTextConfig),
                                               len(params["layers"]), out, mid // out, dtype),
                  params, device)


def adapter_from_jax(params: dict, dtype=torch.float32, device="cuda"):
    """A JAX ``init_adapter_params`` / ``adapter_from_torch`` tree ->
    ``models.nexus_gen_projector.NexusGenAdapter``."""
    from physicedit_torch.models.nexus_gen_projector import NexusGenAdapter

    d_in, d_out = np.shape(params["fc1"]["w"])
    return _carry(NexusGenAdapter(d_in, d_out, dtype), params, device)


def to_jax_tree(module: nn.Module, grads: bool = False) -> dict:
    """The inverse walk of :func:`load_tree_` for float modules: ``nn.Linear``
    -> ``{"w": [in, out], "b"}``, ``nn.ModuleList`` -> a list, a parameter ->
    its array; NumPy fp32.  ``grads`` takes each parameter's ``.grad``
    instead (zeros where it has none)."""
    def val(p):
        t = p.grad if grads else p
        return np.zeros(p.shape, np.float32) if t is None else t.detach().float().cpu().numpy()

    if isinstance(module, nn.Linear):
        out = {"w": val(module.weight).T}
        if module.bias is not None:
            out["b"] = val(module.bias)
        return out
    if isinstance(module, nn.ModuleList):
        return [to_jax_tree(m, grads) for m in module]
    tree = {name: val(p) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        tree[name] = to_jax_tree(child, grads)
    return tree


def pipeline_from_jax(jpipe, device="cuda"):
    """The port's pipeline with the weights, configs, tokenizer and token ids
    of a JAX ``PhysicEditPipeline``, and its blockwise ControlNet and the
    DINOv2 of training when the JAX pipeline has them."""
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    dtype = getattr(torch, np.dtype(jpipe.dtype).name)
    adapter = jpipe.adapters.get("visual_thinking_adapter")
    dino = getattr(jpipe, "dinov2_params", None)
    cn = jpipe.controlnet_params
    return PhysicEditPipeline(
        dit=dit_from_jax(jpipe.dit_params, jpipe.dit_cfg, dtype, device),
        vae=vae_from_jax(jpipe.vae_params, jpipe.vae_cfg, dtype, device),
        text=text_from_jax(jpipe.text_params, jpipe.text_cfg, dtype, device),
        vision=vision_from_jax(jpipe.vision_params, jpipe.vision_cfg, dtype, device),
        adapter=None if adapter is None else dual_adapter_from_jax(adapter, dtype, device),
        dinov2=None if dino is None else dinov2_from_jax(dino, jpipe.dinov2_cfg, dtype, device),
        tokenizer=jpipe.tokenizer, dtype=dtype, device=device,
        boi_token_id=jpipe.boi_token_id, eoi_token_id=jpipe.eoi_token_id,
        image_pad_id=jpipe.image_pad_id, vision_start_id=jpipe.vision_start_id,
        edit_drop_idx=jpipe.edit_drop_idx, t2i_drop_idx=jpipe.t2i_drop_idx,
        rope_axes=tuple(jpipe.rope_axes), txt_len_bucket=jpipe.txt_len_bucket,
        kv_int8=jpipe.kv_int8,
        controlnet=None if cn is None else controlnet_from_jax(cn, dtype, device))
