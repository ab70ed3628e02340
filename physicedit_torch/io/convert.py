"""State dicts in the reference's torch layout <-> the port's modules
(``physicedit_tpu/io/convert.py``).

The port's ``nn.Linear`` and ``nn.Conv2d`` already hold torch's ``[out, in]``
and OIHW layouts, so a checkpoint loads straight into the modules, with no
transposes and no JAX-shaped tree in between.  Each family has a key map: a
list of rows ``(port parameter, reference keys, kind)``, where the kind says
how the reference tensors become the parameter:

- ``COPY``: the same tensor;
- ``CAT``: the reference tensors concatenated along dim 0 (the fused QKV
  projections of the DiT and of DINOv2);
- ``("tap", kt)``: a causal Conv3d ``[O, I, kt, kh, kw]`` in image mode, of
  which only the last temporal tap meets a single frame: ``w[:, :, -1]``;
  into a 5-D parameter (the video VAE's ``CausalConv3d``) the whole kernel;
- ``("reshape", shape)``: the same values in another shape (the VAE's
  ``[C, 1, 1(, 1)]`` norm gains, the ViT's Conv3d patch embedding).

:func:`load_module_` reads a map forwards (every parameter of the module must
be covered), :func:`module_state_dict` backwards: the reference-layout
state dict of a module, the unread taps zero.  ``*_EXTRA`` maps name the
tensors of the published files that the loaders do not read (the VAE's
temporal ``time_conv`` convolutions, DINOv2's ``mask_token`` and final
LayerNorm); the writer fills them with zeros (ones for a LayerNorm weight)
so a written tree has the published key set.

Key spaces: the DiT as ``transformer_blocks.{i}.*`` (the reference's
``qwen_image_dit.py``), the FLUX DiT as diffusers' ``FluxTransformer2DModel``,
the VAE as diffusers' Qwen-Image VAE, the text encoder as HF Qwen2.5-VL
(``model.*`` / ``visual.*`` in the file, remapped to ``model.language_model.*``
/ ``model.visual.*`` as the reference does at load), DINOv2 as HF
``Dinov2WithRegistersModel``, the adapters as the reference's ``pipe.*``
modules.  The configs are inferred from the tensors'
shapes and the ``config.json`` files beside them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from physicedit_torch.core.params import materialize
from physicedit_torch.models.adapters import DualAdapter, PerceiverResampler, visual_thinking_head
from physicedit_torch.models.dinov2 import DINOV2_BASE, DinoV2, DinoV2Config
from physicedit_torch.models.dit import QWEN_IMAGE_CONFIG, DiT, DiTConfig
from physicedit_torch.models.flux import FLUX_KONTEXT_CONFIG, FluxConfig, FluxDiT
from physicedit_torch.models.qwen_vl import QWEN25_VL_7B_TEXT, QwenVLText, QwenVLTextConfig
from physicedit_torch.models.qwen_vl_vision import (QWEN25_VL_VISION, QwenVLVision,
                                                    QwenVLVisionConfig)
from physicedit_torch.models.vae import QWEN_VAE_CONFIG, VAE, VAEConfig
from physicedit_torch.models.vae3d import VideoVAE

COPY = ("copy",)
CAT = ("cat",)


# ---------------------------------------------------------------------------
# Reading and writing a key map
# ---------------------------------------------------------------------------

def _from_reference(kind, tensors: list, shape) -> torch.Tensor:
    if kind[0] == "cat":
        return torch.cat(tensors, dim=0)
    (t,) = tensors
    if kind[0] == "tap":
        return t[:, :, -1] if t.dim() == 5 and len(shape) == 4 else t
    if kind[0] == "reshape":
        return t.reshape(shape)
    return t


def _to_reference(kind, p: torch.Tensor, n_keys: int) -> list:
    if kind[0] == "cat":
        return list(p.chunk(n_keys, dim=0))
    if kind[0] == "tap" and p.dim() == 5:
        return [p]
    if kind[0] == "tap":
        kt = kind[1]
        w = torch.zeros(p.shape[:2] + (kt,) + p.shape[2:], dtype=p.dtype, device=p.device)
        w[:, :, -1] = p
        return [w]
    if kind[0] == "reshape":
        return [p.reshape(kind[1])]
    return [p]


def _tensors(module: nn.Module) -> dict:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


@torch.no_grad()
def load_module_(module: nn.Module, sd: dict, rows: list) -> nn.Module:
    """Copy the reference tensors of ``rows`` into ``module`` (each cast to
    the parameter's dtype and moved to its device); raises if a key is
    missing, a shape differs, or a parameter is left uncovered."""
    params = _tensors(module)
    seen = set()
    for name, keys, kind in rows:
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"{type(module).__name__}.{name}: checkpoint lacks {missing}")
        p = params[name]
        t = _from_reference(kind, [sd[k] for k in keys], p.shape)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{type(module).__name__}.{name}: {keys} give "
                             f"{tuple(t.shape)}, the module has {tuple(p.shape)}")
        p.copy_(t)
        seen.add(name)
    left = sorted(set(params) - seen)
    if left:
        raise ValueError(f"{type(module).__name__}: the key map leaves {left[:5]} unset")
    return module


@torch.no_grad()
def module_state_dict(module: nn.Module, rows: list, extra: list = ()) -> dict:
    """The reference-layout state dict of ``module`` (views of its
    parameters where the layouts agree), plus the ``extra`` tensors
    ``(key, shape, fill)`` in the module's dtype on its device."""
    params = _tensors(module)
    out = {}
    for name, keys, kind in rows:
        for key, t in zip(keys, _to_reference(kind, params[name], len(keys))):
            out[key] = t
    if extra:
        like = next(iter(params.values()))
        for key, shape, fill in extra:
            out[key] = torch.full(shape, fill, dtype=like.dtype, device=like.device)
    return out


def _lin(rows: list, param: str, ref: str, bias: bool = True) -> None:
    rows.append((f"{param}.weight", (f"{ref}.weight",), COPY))
    if bias:
        rows.append((f"{param}.bias", (f"{ref}.bias",), COPY))


def _lin_cat(rows: list, param: str, refs: tuple) -> None:
    rows.append((f"{param}.weight", tuple(f"{r}.weight" for r in refs), CAT))
    rows.append((f"{param}.bias", tuple(f"{r}.bias" for r in refs), CAT))


def _layer_count(sd: dict, prefix: str) -> int:
    ids = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    if not ids:
        raise KeyError(f"no {prefix}* keys in the checkpoint")
    return 1 + max(ids)


# ---------------------------------------------------------------------------
# DiT (transformer_blocks.{i}.*)
# ---------------------------------------------------------------------------

def dit_key_map(num_layers: int) -> list:
    rows: list = []
    _lin(rows, "img_in", "img_in")
    rows.append(("txt_norm.scale", ("txt_norm.weight",), COPY))
    _lin(rows, "txt_in", "txt_in")
    _lin(rows, "time_embed.linear_1", "time_text_embed.timestep_embedder.linear_1")
    _lin(rows, "time_embed.linear_2", "time_text_embed.timestep_embedder.linear_2")
    _lin(rows, "norm_out.linear", "norm_out.linear")
    _lin(rows, "proj_out", "proj_out")
    for i in range(num_layers):
        p, r = f"blocks.{i}", f"transformer_blocks.{i}"
        _lin(rows, f"{p}.img_mod", f"{r}.img_mod.1")
        _lin(rows, f"{p}.txt_mod", f"{r}.txt_mod.1")
        _lin_cat(rows, f"{p}.attn.img_qkv", (f"{r}.attn.to_q", f"{r}.attn.to_k", f"{r}.attn.to_v"))
        _lin_cat(rows, f"{p}.attn.txt_qkv", (f"{r}.attn.add_q_proj", f"{r}.attn.add_k_proj",
                                             f"{r}.attn.add_v_proj"))
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            rows.append((f"{p}.attn.{n}.scale", (f"{r}.attn.{n}.weight",), COPY))
        _lin(rows, f"{p}.attn.to_out", f"{r}.attn.to_out.0")
        _lin(rows, f"{p}.attn.to_add_out", f"{r}.attn.to_add_out")
        for s in ("img", "txt"):
            _lin(rows, f"{p}.{s}_mlp.fc1", f"{r}.{s}_mlp.net.0.proj")
            _lin(rows, f"{p}.{s}_mlp.fc2", f"{r}.{s}_mlp.net.2")
    return rows


def dit_config_from_state_dict(sd: dict) -> DiTConfig:
    """The DiT's config from its tensors' shapes (QWEN_IMAGE_CONFIG on the
    published checkpoint); ``dit_config_from_params`` of the JAX package."""
    head_dim = int(sd["transformer_blocks.0.attn.norm_q.weight"].shape[0])
    dim, patch_dim = (int(x) for x in sd["img_in.weight"].shape)
    return dataclasses.replace(
        QWEN_IMAGE_CONFIG, num_layers=_layer_count(sd, "transformer_blocks."), dim=dim,
        num_heads=dim // head_dim, head_dim=head_dim,
        txt_in_dim=int(sd["txt_norm.weight"].shape[0]), patch_dim=patch_dim,
        time_dim=int(sd["time_text_embed.timestep_embedder.linear_1.weight"].shape[1]))


def dit_from_state_dict(sd: dict, dtype=torch.bfloat16, device="cuda") -> DiT:
    cfg = dit_config_from_state_dict(sd)
    dit = materialize(DiT(cfg, dtype), device)
    return load_module_(dit, sd, dit_key_map(cfg.num_layers)).eval()


def dit_to_state_dict(dit: DiT) -> dict:
    return module_state_dict(dit, dit_key_map(dit.cfg.num_layers))


# ---------------------------------------------------------------------------
# FLUX DiT (diffusers' FluxTransformer2DModel: transformer_blocks.{i}.*,
# single_transformer_blocks.{i}.*)
# ---------------------------------------------------------------------------

def flux_key_map(num_layers: int, num_single_layers: int) -> list:
    """The port's ``models.flux.FluxDiT`` from diffusers' key space.  The
    QKV projections are fused (``to_q``, ``to_k``, ``to_v`` and the text
    stream's ``add_*_proj``, in that order); ``norm_out.linear`` keeps
    diffusers' scale-then-shift order, which the port reads as is (the
    original BFL file's ``final_layer.adaLN_modulation.1`` is shift first,
    and its converter swaps the halves)."""
    rows: list = []
    _lin(rows, "x_embedder", "x_embedder")
    _lin(rows, "context_embedder", "context_embedder")
    for port, ref in (("time_embed", "timestep_embedder"), ("guidance_embed", "guidance_embedder"),
                      ("pooled_embed", "text_embedder")):
        for n in ("linear_1", "linear_2"):
            _lin(rows, f"{port}.{n}", f"time_text_embed.{ref}.{n}")
    _lin(rows, "norm_out.linear", "norm_out.linear")
    _lin(rows, "proj_out", "proj_out")
    for i in range(num_layers):
        p, r = f"blocks.{i}", f"transformer_blocks.{i}"
        _lin(rows, f"{p}.img_mod", f"{r}.norm1.linear")
        _lin(rows, f"{p}.txt_mod", f"{r}.norm1_context.linear")
        _lin_cat(rows, f"{p}.attn.img_qkv", (f"{r}.attn.to_q", f"{r}.attn.to_k", f"{r}.attn.to_v"))
        _lin_cat(rows, f"{p}.attn.txt_qkv", (f"{r}.attn.add_q_proj", f"{r}.attn.add_k_proj",
                                             f"{r}.attn.add_v_proj"))
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            rows.append((f"{p}.attn.{n}.scale", (f"{r}.attn.{n}.weight",), COPY))
        _lin(rows, f"{p}.attn.to_out", f"{r}.attn.to_out.0")
        _lin(rows, f"{p}.attn.to_add_out", f"{r}.attn.to_add_out")
        for s, ff in (("img", "ff"), ("txt", "ff_context")):
            _lin(rows, f"{p}.{s}_mlp.fc1", f"{r}.{ff}.net.0.proj")
            _lin(rows, f"{p}.{s}_mlp.fc2", f"{r}.{ff}.net.2")
    for i in range(num_single_layers):
        p, r = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        _lin(rows, f"{p}.mod", f"{r}.norm.linear")
        _lin_cat(rows, f"{p}.attn.qkv", (f"{r}.attn.to_q", f"{r}.attn.to_k", f"{r}.attn.to_v"))
        for n in ("norm_q", "norm_k"):
            rows.append((f"{p}.attn.{n}.scale", (f"{r}.attn.{n}.weight",), COPY))
        _lin(rows, f"{p}.proj_mlp", f"{r}.proj_mlp")
        _lin(rows, f"{p}.proj_out", f"{r}.proj_out")
    return rows


def flux_config_from_state_dict(sd: dict) -> FluxConfig:
    """The FLUX DiT's config from its tensors' shapes (FLUX_KONTEXT_CONFIG on
    the published checkpoint)."""
    head_dim = int(sd["transformer_blocks.0.attn.norm_q.weight"].shape[0])
    dim, patch_dim = (int(x) for x in sd["x_embedder.weight"].shape)
    return dataclasses.replace(
        FLUX_KONTEXT_CONFIG, num_layers=_layer_count(sd, "transformer_blocks."),
        num_single_layers=_layer_count(sd, "single_transformer_blocks."), dim=dim,
        num_heads=dim // head_dim, head_dim=head_dim,
        txt_in_dim=int(sd["context_embedder.weight"].shape[1]),
        pooled_dim=int(sd["time_text_embed.text_embedder.linear_1.weight"].shape[1]),
        patch_dim=patch_dim,
        time_dim=int(sd["time_text_embed.timestep_embedder.linear_1.weight"].shape[1]))


def flux_from_state_dict(sd: dict, dtype=torch.bfloat16, device="cuda") -> FluxDiT:
    cfg = flux_config_from_state_dict(sd)
    dit = materialize(FluxDiT(cfg, dtype), device)
    return load_module_(dit, sd, flux_key_map(cfg.num_layers, cfg.num_single_layers)).eval()


def flux_to_state_dict(dit: FluxDiT) -> dict:
    return module_state_dict(dit, flux_key_map(dit.cfg.num_layers, dit.cfg.num_single_layers))


# ---------------------------------------------------------------------------
# VAE (diffusers' Qwen-Image VAE key space)
# ---------------------------------------------------------------------------

# the stages whose resample also has a temporal conv in the published file
_TEMPORAL_DOWN = (False, True, True)
_TEMPORAL_UP = (True, True, False)


def _vae_res(rows, p, r, cin, cout):
    rows.append((f"{p}.norm1.gamma", (f"{r}.norm1.gamma",), ("reshape", (cin, 1, 1, 1))))
    rows.append((f"{p}.conv1.weight", (f"{r}.conv1.weight",), ("tap", 3)))
    rows.append((f"{p}.conv1.bias", (f"{r}.conv1.bias",), COPY))
    rows.append((f"{p}.norm2.gamma", (f"{r}.norm2.gamma",), ("reshape", (cout, 1, 1, 1))))
    rows.append((f"{p}.conv2.weight", (f"{r}.conv2.weight",), ("tap", 3)))
    rows.append((f"{p}.conv2.bias", (f"{r}.conv2.bias",), COPY))
    if cin != cout:
        rows.append((f"{p}.shortcut.weight", (f"{r}.conv_shortcut.weight",), ("tap", 1)))
        rows.append((f"{p}.shortcut.bias", (f"{r}.conv_shortcut.bias",), COPY))


def _vae_mid(rows, p, r, c):
    _vae_res(rows, f"{p}.res0", f"{r}.resnets.0", c, c)
    rows.append((f"{p}.attn.norm.gamma", (f"{r}.attentions.0.norm.gamma",),
                 ("reshape", (c, 1, 1))))
    _lin(rows, f"{p}.attn.to_qkv", f"{r}.attentions.0.to_qkv")
    _lin(rows, f"{p}.attn.proj", f"{r}.attentions.0.proj")
    _vae_res(rows, f"{p}.res1", f"{r}.resnets.1", c, c)


def _conv3d(rows, p, r, kt):
    rows.append((f"{p}.weight", (f"{r}.weight",), ("tap", kt)))
    rows.append((f"{p}.bias", (f"{r}.bias",), COPY))


def vae_key_map(cfg: VAEConfig) -> list:
    rows: list = []
    enc, dec, n_st = cfg.enc_dims, cfg.dec_dims, len(cfg.dim_mult)
    _conv3d(rows, "encoder.conv_in", "encoder.conv_in", 3)
    idx = 0
    for s, (cin, cout) in enumerate(zip(enc[:-1], enc[1:])):
        for r in range(cfg.num_res_blocks):
            _vae_res(rows, f"encoder.stages.{s}.res.{r}", f"encoder.down_blocks.{idx}",
                     cin if r == 0 else cout, cout)
            idx += 1
        if s != n_st - 1:
            _lin(rows, f"encoder.stages.{s}.down", f"encoder.down_blocks.{idx}.resample.1")
            idx += 1
    _vae_mid(rows, "encoder.mid", "encoder.mid_block", enc[-1])
    rows.append(("encoder.norm_out.gamma", ("encoder.norm_out.gamma",),
                 ("reshape", (enc[-1], 1, 1, 1))))
    _conv3d(rows, "encoder.conv_out", "encoder.conv_out", 3)
    _conv3d(rows, "decoder.conv_in", "decoder.conv_in", 3)
    _vae_mid(rows, "decoder.mid", "decoder.mid_block", dec[0])
    for s, (cin, cout) in enumerate(zip(dec[:-1], dec[1:])):
        cin = cin // 2 if s > 0 else cin
        for r in range(cfg.num_res_blocks + 1):
            _vae_res(rows, f"decoder.stages.{s}.res.{r}", f"decoder.up_blocks.{s}.resnets.{r}",
                     cin if r == 0 else cout, cout)
        if s != n_st - 1:
            _lin(rows, f"decoder.stages.{s}.up", f"decoder.up_blocks.{s}.upsamplers.0.resample.1")
    rows.append(("decoder.norm_out.gamma", ("decoder.norm_out.gamma",),
                 ("reshape", (dec[-1], 1, 1, 1))))
    _conv3d(rows, "decoder.conv_out", "decoder.conv_out", 3)
    _conv3d(rows, "quant_conv", "quant_conv", 1)
    _conv3d(rows, "post_quant_conv", "post_quant_conv", 1)
    return rows


def vae_extra_keys(cfg: VAEConfig) -> list:
    """The published file's temporal ``time_conv`` convolutions (dead in
    image mode; the JAX package's converter drops them too):
    ``(key, shape, fill)``."""
    extra = []
    enc, dec = cfg.enc_dims, cfg.dec_dims
    idx = 0
    for s, c in enumerate(enc[1:-1]):
        idx += cfg.num_res_blocks
        if _TEMPORAL_DOWN[s]:
            r = f"encoder.down_blocks.{idx}.time_conv"
            extra += [(f"{r}.weight", (c, c, 3, 1, 1), 0.0), (f"{r}.bias", (c,), 0.0)]
        idx += 1
    for s, c in enumerate(dec[1:-1]):
        if _TEMPORAL_UP[s]:
            r = f"decoder.up_blocks.{s}.upsamplers.0.time_conv"
            extra += [(f"{r}.weight", (2 * c, c, 3, 1, 1), 0.0), (f"{r}.bias", (2 * c,), 0.0)]
    return extra


def vae_config_from_state_dict(sd: dict) -> VAEConfig:
    """``vae_config_from_params`` of the JAX package: base_dim and z_dim."""
    return dataclasses.replace(QWEN_VAE_CONFIG,
                               base_dim=int(sd["encoder.conv_in.weight"].shape[0]),
                               z_dim=int(sd["quant_conv.weight"].shape[0]) // 2)


def vae_from_state_dict(sd: dict, dtype=torch.bfloat16, device="cuda") -> VAE:
    cfg = vae_config_from_state_dict(sd)
    vae = materialize(VAE(cfg, dtype), device)
    return load_module_(vae, sd, vae_key_map(cfg)).eval()


def vae_to_state_dict(vae: VAE) -> dict:
    return module_state_dict(vae, vae_key_map(vae.cfg), vae_extra_keys(vae.cfg))


def vae3d_from_state_dict(sd: dict, dtype=torch.bfloat16, device="cuda") -> VideoVAE:
    """The video-mode VAE (``models/vae3d.py``) from the same file: the same
    key map, the causal convs keeping all ``kt`` temporal taps (JAX
    ``vae_video_from_torch``); the ``time_conv`` keys are read by nothing."""
    cfg = vae_config_from_state_dict(sd)
    vae = materialize(VideoVAE(cfg, dtype), device)
    return load_module_(vae, sd, vae_key_map(cfg)).eval()


# ---------------------------------------------------------------------------
# Qwen2.5-VL text decoder and vision tower
# ---------------------------------------------------------------------------

def remap_text_encoder_keys(sd: dict) -> dict:
    """The reference's load-time remap (``_remap_text_encoder_keys`` of the
    JAX package): visual.* -> model.visual.*, model.* ->
    model.language_model.*."""
    out = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            k = "model." + k
        elif (k.startswith("model.") and not k.startswith("model.language_model.")
              and not k.startswith("model.visual.")):
            k = k.replace("model.", "model.language_model.", 1)
        out[k] = v
    return out


def _detect_prefix(sd: dict, candidates, probe: str) -> str:
    """The first candidate prefix under which ``probe`` exists (both the
    remapped and the HF ``save_pretrained`` key spaces load)."""
    for c in candidates:
        if any(k.startswith(c + probe) for k in sd):
            return c
    raise KeyError(f"none of {candidates} + {probe!r} found in checkpoint "
                   f"(sample keys: {sorted(sd)[:5]})")


def text_key_map(num_layers: int, base: str = "model.") -> list:
    rows: list = [("embed", (base + "embed_tokens.weight",), COPY)]
    for i in range(num_layers):
        p, r = f"layers.{i}", f"{base}layers.{i}"
        rows.append((f"{p}.ln1.scale", (f"{r}.input_layernorm.weight",), COPY))
        for n in ("q", "k", "v"):
            _lin(rows, f"{p}.{n}", f"{r}.self_attn.{n}_proj")
        _lin(rows, f"{p}.o", f"{r}.self_attn.o_proj", bias=False)
        rows.append((f"{p}.ln2.scale", (f"{r}.post_attention_layernorm.weight",), COPY))
        for n in ("gate", "up", "down"):
            _lin(rows, f"{p}.mlp.{n}", f"{r}.mlp.{n}_proj", bias=False)
    rows.append(("norm.scale", (base + "norm.weight",), COPY))
    _lin(rows, "lm_head", "lm_head", bias=False)
    return rows


def vision_key_map(cfg: QwenVLVisionConfig, base: str = "visual.") -> list:
    patch = (cfg.hidden_size, 3, cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
    rows: list = [("patch_embed.weight", (base + "patch_embed.proj.weight",),
                   ("reshape", patch))]
    for i in range(cfg.depth):
        p, r = f"blocks.{i}", f"{base}blocks.{i}"
        rows.append((f"{p}.norm1.scale", (f"{r}.norm1.weight",), COPY))
        _lin(rows, f"{p}.qkv", f"{r}.attn.qkv")
        _lin(rows, f"{p}.proj", f"{r}.attn.proj")
        rows.append((f"{p}.norm2.scale", (f"{r}.norm2.weight",), COPY))
        for n in ("gate", "up", "down"):
            _lin(rows, f"{p}.mlp.{n}", f"{r}.mlp.{n}_proj")
    rows.append(("merger.ln_q.scale", (base + "merger.ln_q.weight",), COPY))
    _lin(rows, "merger.fc1", base + "merger.mlp.0")
    _lin(rows, "merger.fc2", base + "merger.mlp.2")
    return rows


def text_config_from_hf(hf: dict) -> QwenVLTextConfig:
    """QwenVLTextConfig from an HF Qwen2.5-VL config.json dict."""
    heads = int(hf["num_attention_heads"])
    hidden = int(hf["hidden_size"])
    base = QWEN25_VL_7B_TEXT
    sec = (hf.get("rope_scaling") or {}).get("mrope_section") or list(base.mrope_section)
    return dataclasses.replace(
        base, hidden_size=hidden, num_layers=int(hf["num_hidden_layers"]), num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads", heads)),
        head_dim=int(hf.get("head_dim", hidden // heads)),
        intermediate_size=int(hf["intermediate_size"]), vocab_size=int(hf["vocab_size"]),
        rope_theta=float(hf.get("rope_theta", 1e6)), mrope_section=tuple(sec),
        eps=float(hf.get("rms_norm_eps", 1e-6)),
        image_token_id=int(hf.get("image_token_id", 151655)),
        video_token_id=int(hf.get("video_token_id", 151656)),
        vision_start_token_id=int(hf.get("vision_start_token_id", 151652)),
        eos_token_id=int(hf.get("eos_token_id", 151645)))


def vision_config_from_hf(hf: dict) -> QwenVLVisionConfig:
    """QwenVLVisionConfig from the ``vision_config`` block of config.json."""
    v = hf.get("vision_config", hf)
    base = QWEN25_VL_VISION
    return dataclasses.replace(
        base, **{f: type(getattr(base, f))(v.get(f, getattr(base, f))) for f in (
            "depth", "hidden_size", "num_heads", "intermediate_size", "patch_size",
            "temporal_patch_size", "spatial_merge_size", "window_size",
            "fullatt_block_indexes", "out_hidden_size")})


def text_encoder_hf_config(text: QwenVLTextConfig, vision: QwenVLVisionConfig) -> dict:
    """The fields of an HF Qwen2.5-VL config.json that the two functions
    above read, written from the port's configs."""
    return {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"], "model_type": "qwen2_5_vl",
        "hidden_size": text.hidden_size, "num_hidden_layers": text.num_layers,
        "num_attention_heads": text.num_heads, "num_key_value_heads": text.num_kv_heads,
        "head_dim": text.head_dim, "intermediate_size": text.intermediate_size,
        "vocab_size": text.vocab_size, "rope_theta": text.rope_theta,
        "rope_scaling": {"type": "mrope", "mrope_section": list(text.mrope_section)},
        "rms_norm_eps": text.eps, "image_token_id": text.image_token_id,
        "video_token_id": text.video_token_id,
        "vision_start_token_id": text.vision_start_token_id,
        "eos_token_id": text.eos_token_id, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
        "vision_config": {f: (list(getattr(vision, f)) if f == "fullatt_block_indexes"
                              else getattr(vision, f)) for f in (
            "depth", "hidden_size", "num_heads", "intermediate_size", "patch_size",
            "temporal_patch_size", "spatial_merge_size", "window_size",
            "fullatt_block_indexes", "out_hidden_size")},
    }


def qwen_vl_text_from_state_dict(sd: dict, cfg: QwenVLTextConfig | None = None,
                                 dtype=torch.bfloat16, device="cuda") -> QwenVLText:
    """The text decoder and lm_head from a (remapped) text-encoder state
    dict; ``cfg`` from :func:`text_config_from_hf`, else Qwen2.5-VL-7B's
    with the checkpoint's layer count."""
    base = _detect_prefix(sd, ("model.language_model.", "model."),
                          "layers.0.self_attn.q_proj.weight")
    if cfg is None:
        cfg = dataclasses.replace(QWEN25_VL_7B_TEXT,
                                  num_layers=_layer_count(sd, base + "layers."))
    text = materialize(QwenVLText(cfg, dtype), device)
    return load_module_(text, sd, text_key_map(cfg.num_layers, base)).eval()


def qwen_vl_vision_from_state_dict(sd: dict, cfg: QwenVLVisionConfig | None = None,
                                   dtype=torch.bfloat16, device="cuda") -> QwenVLVision:
    """The vision tower and merger; ``cfg`` from :func:`vision_config_from_hf`,
    else Qwen2.5-VL-7B's with the checkpoint's depth."""
    base = _detect_prefix(sd, ("model.visual.", "visual."), "blocks.0.attn.qkv.weight")
    if cfg is None:
        cfg = dataclasses.replace(QWEN25_VL_VISION, depth=_layer_count(sd, base + "blocks."))
    vision = materialize(QwenVLVision(cfg, dtype), device)
    return load_module_(vision, sd, vision_key_map(cfg, base)).eval()


def text_encoder_to_state_dict(text: QwenVLText, vision: QwenVLVision) -> dict:
    """The published text-encoder file's key space: ``model.*`` and
    ``visual.*``.  The text model must be in its float layout (not after
    ``quantize_``)."""
    return {**module_state_dict(text, text_key_map(text.cfg.num_layers)),
            **module_state_dict(vision, vision_key_map(vision.cfg))}


# ---------------------------------------------------------------------------
# DINOv2 (HF Dinov2WithRegistersModel)
# ---------------------------------------------------------------------------

def dinov2_key_map(num_layers: int) -> list:
    rows: list = [("cls_token", ("embeddings.cls_token",), COPY),
                  ("register_tokens", ("embeddings.register_tokens",), COPY),
                  ("pos_emb", ("embeddings.position_embeddings",), COPY)]
    _lin(rows, "patch_embed", "embeddings.patch_embeddings.projection")
    for i in range(num_layers):
        p, r = f"layers.{i}", f"encoder.layer.{i}"
        for n in ("norm1", "norm2"):
            rows.append((f"{p}.{n}.scale", (f"{r}.{n}.weight",), COPY))
            rows.append((f"{p}.{n}.bias", (f"{r}.{n}.bias",), COPY))
        _lin_cat(rows, f"{p}.qkv", tuple(f"{r}.attention.attention.{n}"
                                         for n in ("query", "key", "value")))
        _lin(rows, f"{p}.out", f"{r}.attention.output.dense")
        rows.append((f"{p}.ls1", (f"{r}.layer_scale1.lambda1",), COPY))
        rows.append((f"{p}.ls2", (f"{r}.layer_scale2.lambda1",), COPY))
        _lin(rows, f"{p}.fc1", f"{r}.mlp.fc1")
        _lin(rows, f"{p}.fc2", f"{r}.mlp.fc2")
    return rows


def dinov2_extra_keys(hidden: int) -> list:
    """Tensors of the HF file the feature path does not read."""
    return [("embeddings.mask_token", (1, hidden), 0.0), ("layernorm.weight", (hidden,), 1.0),
            ("layernorm.bias", (hidden,), 0.0)]


def dinov2_config_from_hf(hf: dict, num_layers: int | None = None) -> DinoV2Config:
    """DinoV2Config from an HF Dinov2WithRegisters config.json dict; the
    layer count from the checkpoint where given."""
    b = DINOV2_BASE
    cfg = DinoV2Config(
        hidden_size=int(hf.get("hidden_size", b.hidden_size)),
        num_layers=int(hf.get("num_hidden_layers", b.num_layers)),
        num_heads=int(hf.get("num_attention_heads", b.num_heads)),
        mlp_ratio=int(hf.get("mlp_ratio", b.mlp_ratio)),
        patch_size=int(hf.get("patch_size", b.patch_size)),
        num_register_tokens=int(hf.get("num_register_tokens", b.num_register_tokens)),
        eps=float(hf.get("layer_norm_eps", b.eps)))
    return cfg if num_layers is None else dataclasses.replace(cfg, num_layers=num_layers)


def dinov2_hf_config(cfg: DinoV2Config) -> dict:
    return {"model_type": "dinov2_with_registers", "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "mlp_ratio": cfg.mlp_ratio, "patch_size": cfg.patch_size,
            "num_register_tokens": cfg.num_register_tokens, "layer_norm_eps": cfg.eps,
            "image_size": 518}


def dinov2_from_state_dict(sd: dict, hf: dict | None = None, dtype=torch.float32,
                           device="cuda") -> DinoV2:
    """DINOv2 from an HF state dict (``hf``: its config.json, else the
    base model's); the position table's side from its shape."""
    cfg = dinov2_config_from_hf(hf or {}, _layer_count(sd, "encoder.layer."))
    grid = math.isqrt(int(sd["embeddings.position_embeddings"].shape[1]) - 1)
    dino = materialize(DinoV2(cfg, grid, dtype), device)
    return load_module_(dino, sd, dinov2_key_map(cfg.num_layers)).eval()


def dinov2_to_state_dict(dino: DinoV2) -> dict:
    return module_state_dict(dino, dinov2_key_map(dino.cfg.num_layers),
                             dinov2_extra_keys(dino.cfg.hidden_size))


# ---------------------------------------------------------------------------
# The PhysicEdit adapters (the pipe.* half of a finetuned checkpoint)
# ---------------------------------------------------------------------------

def dual_adapter_key_map(prefix: str) -> list:
    rows: list = []
    for head in ("head_dino", "head_vae"):
        _lin(rows, f"{head}.fc1", f"{prefix}.{head}.0")
        _lin(rows, f"{head}.fc2", f"{prefix}.{head}.2")
    return rows


def head_key_map(prefix: str) -> list:
    rows: list = []
    _lin(rows, "fc1", f"{prefix}.net.0")
    _lin(rows, "fc2", f"{prefix}.net.2")
    return rows


def perceiver_key_map(prefix: str, depth: int) -> list:
    rows: list = [("latents", (f"{prefix}.latents",), COPY),
                  ("pos_emb", (f"{prefix}.pos_emb.weight",), COPY)]

    def ln(param, ref):
        rows.append((f"{param}.scale", (f"{ref}.weight",), COPY))
        rows.append((f"{param}.bias", (f"{ref}.bias",), COPY))

    for i in range(depth):
        a, f = f"{prefix}.layers.{i}.0", f"{prefix}.layers.{i}.1"
        ln(f"layers.{i}.attn.norm_media", f"{a}.norm_media")
        ln(f"layers.{i}.attn.norm_latents", f"{a}.norm_latents")
        for n in ("to_q", "to_kv", "to_out"):
            _lin(rows, f"layers.{i}.attn.{n}", f"{a}.{n}", bias=False)
        ln(f"layers.{i}.ff.norm", f"{f}.net.0")
        _lin(rows, f"layers.{i}.ff.fc1", f"{f}.net.1")
        _lin(rows, f"layers.{i}.ff.fc2", f"{f}.net.3")
    ln("norm", f"{prefix}.norm")
    return rows


def physic_adapters_from_state_dict(pipe_sd: dict, dtype=torch.float32,
                                    device="cuda") -> dict:
    """The pipeline-level adapter weights (``pipe.*`` keys with the prefix
    stripped) -> ``{group: module or tensor}``: ``visual_thinking_adapter``
    (a ``DualAdapter``), ``{dino,vae}_resampler`` (``PerceiverResampler``),
    ``{dino,vae}_resampler_adapter`` (VisualThinking heads) and
    ``{dino,vae}_time_embed`` (tensors).  Groups missing from the checkpoint
    are absent from the result, as in the JAX package."""
    out: dict = {}

    def has(prefix):
        return any(k.startswith(prefix + ".") for k in pipe_sd)

    def load(module, rows):
        return load_module_(materialize(module, device), pipe_sd, rows).eval()

    name = "visual_thinking_adapter"
    if has(name):
        w1, w2 = pipe_sd[f"{name}.head_dino.0.weight"], pipe_sd[f"{name}.head_dino.2.weight"]
        out[name] = load(DualAdapter(w1.shape[1], w2.shape[0], dtype),
                         dual_adapter_key_map(name))
    for name in ("dino_resampler", "vae_resampler"):
        if has(name):
            lat, pos = pipe_sd[f"{name}.latents"], pipe_sd[f"{name}.pos_emb.weight"]
            depth = _layer_count(pipe_sd, f"{name}.layers.")
            out[name] = load(PerceiverResampler(lat.shape[1], depth, num_latents=lat.shape[0],
                                                max_num_media_tokens=pos.shape[0], dtype=dtype),
                             perceiver_key_map(name, depth))
        head = name + "_adapter"
        if has(head):
            w1, w2 = pipe_sd[f"{head}.net.0.weight"], pipe_sd[f"{head}.net.2.weight"]
            out[head] = load(visual_thinking_head(w1.shape[1], w2.shape[0], dtype),
                             head_key_map(head))
    for name in ("dino_time_embed", "vae_time_embed"):
        if name + ".weight" in pipe_sd:
            out[name] = pipe_sd[name + ".weight"].to(device=device, dtype=dtype)
    return out
