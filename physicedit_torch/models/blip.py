"""BLIP towers for the ImageReward preference scorer
(``physicedit_tpu/models/blip.py``).

The two networks ImageReward's score path uses:

- a timm-style pre-LN ViT (``vit='large'``: width 1024, depth 24, heads 16,
  patch 16, LayerNorm eps 1e-6, exact GELU, a final LayerNorm) returning the
  FULL token sequence (CLS + patches) as cross-attention memory;
- the "med" BERT text encoder (post-LN bert-base, eps 1e-12, with a
  cross-attention sub-layer in every block, run in 'multimodal' mode):
  bidirectional self-attention over the 35-token prompt whose padding mask
  adds ``(1 - mask) * -10000`` to the logits (not ``-inf``),
  cross-attention into the image tokens, positions from 0, a GELU FFN; the
  CLS feature feeds ImageReward's 5-linear MLP head, which has no
  activations.

Attention is the dense :func:`ops.attention.sdpa_xla`, as in the JAX
package.  Pixels are NHWC.  Weights come from the published
``ImageReward.safetensors`` key space via :func:`imagereward_from_state_dict`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear, materialize
from physicedit_torch.ops.attention import sdpa_xla
from physicedit_torch.ops.norms import layer_norm


def _ln(d, dtype):
    return Leaf(scale=(d,), bias=(d,), dtype=dtype)


# ---------------------------------------------------------------------------
# Vision tower (BLIP/vit.py: timm pre-LN ViT)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlipViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.width // self.num_heads


BLIP_VIT_LARGE = BlipViTConfig()


class ViTBlock(nn.Module):
    def __init__(self, cfg: BlipViTConfig, dtype=None):
        super().__init__()
        d, h = cfg.width, cfg.width * cfg.mlp_ratio
        self.cfg = cfg
        self.norm1 = _ln(d, dtype)
        self.qkv = linear(d, 3 * d, dtype=dtype)
        self.proj = linear(d, d, dtype=dtype)
        self.norm2 = _ln(d, dtype)
        self.fc1 = linear(d, h, dtype=dtype)
        self.fc2 = linear(h, d, dtype=dtype)

    def forward(self, x):
        cfg = self.cfg
        b, s, d = x.shape
        h = layer_norm(x, cfg.eps, self.norm1.scale, self.norm1.bias)
        q, k, v = self.qkv(h).reshape(b, s, 3, cfg.num_heads, cfg.head_dim).unbind(2)
        x = x + self.proj(sdpa_xla(q, k, v).reshape(b, s, d))
        h = layer_norm(x, cfg.eps, self.norm2.scale, self.norm2.bias)
        return x + self.fc2(F.gelu(self.fc1(h)))


class BlipViT(nn.Module):
    def __init__(self, cfg: BlipViTConfig = BLIP_VIT_LARGE, dtype=None):
        super().__init__()
        d, ps = cfg.width, cfg.patch_size
        n_pos = (cfg.image_size // ps) ** 2 + 1
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, dtype=dtype, device="meta"))
        self.pos_embed = nn.Parameter(torch.empty(1, n_pos, d, dtype=dtype, device="meta"))
        self.patch_embed = nn.Conv2d(3, d, ps, ps, dtype=dtype, device="meta")
        self.blocks = nn.ModuleList(ViTBlock(cfg, dtype) for _ in range(cfg.depth))
        self.norm = _ln(d, dtype)


@torch.no_grad()
def blip_vit_forward(vit: BlipViT, pixels: torch.Tensor) -> torch.Tensor:
    """CLIP-normalised pixels [B, H, W, 3] -> tokens [B, 1+P, width]: the
    full sequence (CLS first), final-LayerNormed, which is what
    ``blip.visual_encoder(image)`` returns as cross-attention memory."""
    x = vit.patch_embed(pixels.permute(0, 3, 1, 2).to(vit.patch_embed.weight.dtype))
    x = x.flatten(2).transpose(1, 2)
    cls = vit.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + vit.pos_embed.to(x.dtype)
    for block in vit.blocks:
        x = block(x)
    return layer_norm(x, vit.cfg.eps, vit.norm.scale, vit.norm.bias)


# ---------------------------------------------------------------------------
# Text tower (BLIP/med.py: post-LN BERT with per-layer cross-attention)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524          # bert-base + [DEC]/[ENC]
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    encoder_width: int = 1024        # cross-attention K/V input (ViT width)
    eps: float = 1e-12

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


BLIP_MED_BASE = BlipTextConfig()


class BertAttention(nn.Module):
    """One (self- or cross-) attention sub-layer with BERT's post-LN."""

    def __init__(self, cfg: BlipTextConfig, kv_width: int, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.q = linear(d, d, dtype=dtype)
        self.k = linear(kv_width, d, dtype=dtype)
        self.v = linear(kv_width, d, dtype=dtype)
        self.out = linear(d, d, dtype=dtype)
        self.ln = _ln(d, dtype)

    def forward(self, hidden, kv_src, bias):
        cfg = self.cfg
        b, s, _ = hidden.shape
        t = kv_src.shape[1]
        q = self.q(hidden).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k(kv_src).reshape(b, t, cfg.num_heads, cfg.head_dim)
        v = self.v(kv_src).reshape(b, t, cfg.num_heads, cfg.head_dim)
        out = self.out(sdpa_xla(q, k, v, bias=bias).reshape(b, s, -1))
        return layer_norm(out + hidden, cfg.eps, self.ln.scale, self.ln.bias)


class BertLayer(nn.Module):
    def __init__(self, cfg: BlipTextConfig, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.self = BertAttention(cfg, d, dtype)      # the JAX tree's key
        self.cross = BertAttention(cfg, cfg.encoder_width, dtype)
        self.ffn = nn.ModuleDict({"fc1": linear(d, cfg.intermediate_size, dtype=dtype),
                                  "fc2": linear(cfg.intermediate_size, d, dtype=dtype),
                                  "ln": _ln(d, dtype)})

    def forward(self, x, encoder_states, self_bias, cross_bias):
        x = self.self(x, x, self_bias)
        x = self.cross(x, encoder_states, cross_bias)
        ffn = self.ffn
        h = ffn["fc2"](F.gelu(ffn["fc1"](x)))
        return layer_norm(h + x, self.cfg.eps, ffn["ln"].scale, ffn["ln"].bias)


class BlipText(nn.Module):
    def __init__(self, cfg: BlipTextConfig = BLIP_MED_BASE, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, d, dtype=dtype,
                                                        device="meta"))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position, d, dtype=dtype,
                                                            device="meta"))
        self.emb_ln = _ln(d, dtype)
        self.layers = nn.ModuleList(BertLayer(cfg, dtype) for _ in range(cfg.num_layers))


def _mask_bias(mask, dtype):
    """[B, S_k] 1/0 mask -> additive bias [B, 1, 1, S_k] (med.py semantics:
    (1 - mask) * -10000 added to the attention scores)."""
    if mask is None:
        return None
    return ((1.0 - mask.float()) * -10000.0)[:, None, None, :].to(dtype)


@torch.no_grad()
def blip_text_forward(text: BlipText, input_ids, attention_mask, encoder_states,
                      encoder_mask=None) -> torch.Tensor:
    """'multimodal' text encoder (med.py BertModel, add_pooling_layer=False).

    input_ids: [B, S] int; attention_mask: [B, S] (1 = live);
    encoder_states: [B, S_img, encoder_width] image tokens.
    Returns last_hidden_state [B, S, hidden].
    """
    cfg = text.cfg
    s = input_ids.shape[1]
    emb = text.word_embeddings[input_ids.long()] + text.position_embeddings[None, :s]
    x = layer_norm(emb, cfg.eps, text.emb_ln.scale, text.emb_ln.bias)
    self_bias = _mask_bias(attention_mask, x.dtype)
    cross_bias = _mask_bias(encoder_mask, x.dtype)
    for layer in text.layers:
        x = layer(x, encoder_states, self_bias, cross_bias)
    return x


# ---------------------------------------------------------------------------
# ImageReward head + end-to-end score
# ---------------------------------------------------------------------------

# Score normalisation constants (imagereward.py:64-65).
IMAGEREWARD_MEAN = 0.16717362830052426
IMAGEREWARD_STD = 1.0333394966054072
# the published head's widths: 768 -> 1024 -> 128 -> 64 -> 16 -> 1
IMAGEREWARD_MLP = (768, 1024, 128, 64, 16, 1)


class ImageReward(nn.Module):
    """{vit, text, mlp}; the MLP head is kept in fp32 whatever ``dtype``."""

    def __init__(self, vit_cfg: BlipViTConfig = BLIP_VIT_LARGE,
                 txt_cfg: BlipTextConfig = BLIP_MED_BASE, mlp_dims=IMAGEREWARD_MLP, dtype=None):
        super().__init__()
        self.vit = BlipViT(vit_cfg, dtype)
        self.text = BlipText(txt_cfg, dtype)
        self.mlp = nn.ModuleList(linear(a, b, dtype=torch.float32)
                                 for a, b in zip(mlp_dims[:-1], mlp_dims[1:]))


@torch.no_grad()
def init_imagereward_(model: ImageReward, generator: torch.Generator) -> ImageReward:
    """Random weights (tests, the card's smoke): linears and the patch
    embedding as ``core/params.init_random_``, LayerNorms 1 / 0, the tokens,
    positions and word embeddings N(0, 0.02^2)."""
    from physicedit_torch.core.params import init_random_

    init_random_(model, generator)
    for p in (model.vit.cls_token, model.vit.pos_embed, model.text.word_embeddings,
              model.text.position_embeddings):
        p.normal_(0.0, 0.02, generator=generator)
    return model


@torch.no_grad()
def imagereward_score(model: ImageReward, pixels, input_ids, attention_mask) -> torch.Tensor:
    """The full reward: BLIP ViT -> med cross-encoder -> CLS -> MLP ->
    (r - mean) / std."""
    image_embeds = blip_vit_forward(model.vit, pixels)
    hidden = blip_text_forward(model.text, input_ids, attention_mask, image_embeds)
    x = hidden[:, 0, :].float()
    for lin in model.mlp:
        x = lin(x)
    return (x[:, 0] - IMAGEREWARD_MEAN) / IMAGEREWARD_STD


# ---------------------------------------------------------------------------
# Weight conversion (ImageReward.safetensors key space)
# ---------------------------------------------------------------------------

def _rows_ln(rows, param, ref):
    rows += [(f"{param}.scale", f"{ref}.weight"), (f"{param}.bias", f"{ref}.bias")]


def _rows_lin(rows, param, ref):
    rows += [(f"{param}.weight", f"{ref}.weight"), (f"{param}.bias", f"{ref}.bias")]


def _load(module, sd, rows):
    """Copy the reference tensors named by ``rows`` (port parameter,
    reference key) into ``module``; every parameter must be covered."""
    from physicedit_torch.io.convert import COPY, load_module_

    tensors = {r: torch.as_tensor(sd[r]) for _, r in rows if r in sd}
    return load_module_(module, tensors, [(p, (r,), COPY) for p, r in rows]).eval()


def blip_vit_key_map(depth: int, prefix: str = "") -> list:
    """timm-ViT key space (BLIP/vit.py): blocks.N.attn.qkv etc."""
    rows = [("cls_token", prefix + "cls_token"), ("pos_embed", prefix + "pos_embed")]
    _rows_lin(rows, "patch_embed", prefix + "patch_embed.proj")
    for i in range(depth):
        p, r = f"blocks.{i}", f"{prefix}blocks.{i}"
        _rows_ln(rows, f"{p}.norm1", f"{r}.norm1")
        _rows_lin(rows, f"{p}.qkv", f"{r}.attn.qkv")
        _rows_lin(rows, f"{p}.proj", f"{r}.attn.proj")
        _rows_ln(rows, f"{p}.norm2", f"{r}.norm2")
        _rows_lin(rows, f"{p}.fc1", f"{r}.mlp.fc1")
        _rows_lin(rows, f"{p}.fc2", f"{r}.mlp.fc2")
    _rows_ln(rows, "norm", prefix + "norm")
    return rows


def blip_vit_config(sd, prefix="", num_heads=None) -> BlipViTConfig:
    from physicedit_torch.io.convert import _layer_count

    g = lambda k: tuple(np.shape(sd[prefix + k]))
    width = g("cls_token")[-1]
    patch = g("patch_embed.proj.weight")[-1]
    return BlipViTConfig(
        image_size=int(round(float(np.sqrt(g("pos_embed")[1] - 1)))) * patch,
        patch_size=patch, width=width, depth=_layer_count(sd, prefix + "blocks."),
        num_heads=(num_heads if num_heads is not None
                   else {768: 12, 1024: 16}.get(width, max(1, width // 64))),
        mlp_ratio=g("blocks.0.mlp.fc1.weight")[0] // width)


def blip_vit_from_torch(sd, prefix="", dtype=torch.float32, num_heads=None, device="cuda"):
    """-> (BlipViT on ``device``, cfg); the config from the shapes."""
    cfg = blip_vit_config(sd, prefix, num_heads)
    return _load(materialize(BlipViT(cfg, dtype), device), sd,
                 blip_vit_key_map(cfg.depth, prefix)), cfg


def blip_text_key_map(num_layers: int, prefix: str = "") -> list:
    """med-BERT key space: encoder.layer.N.{attention,crossattention,...}."""
    rows = [("word_embeddings", prefix + "embeddings.word_embeddings.weight"),
            ("position_embeddings", prefix + "embeddings.position_embeddings.weight")]
    _rows_ln(rows, "emb_ln", prefix + "embeddings.LayerNorm")
    for i in range(num_layers):
        p, r = f"layers.{i}", f"{prefix}encoder.layer.{i}"
        for part, ref in (("self", "attention"), ("cross", "crossattention")):
            for name, key in (("q", "self.query"), ("k", "self.key"), ("v", "self.value"),
                              ("out", "output.dense")):
                _rows_lin(rows, f"{p}.{part}.{name}", f"{r}.{ref}.{key}")
            _rows_ln(rows, f"{p}.{part}.ln", f"{r}.{ref}.output.LayerNorm")
        _rows_lin(rows, f"{p}.ffn.fc1", f"{r}.intermediate.dense")
        _rows_lin(rows, f"{p}.ffn.fc2", f"{r}.output.dense")
        _rows_ln(rows, f"{p}.ffn.ln", f"{r}.output.LayerNorm")
    return rows


def blip_text_config(sd, prefix="", encoder_width=None, num_heads=None) -> BlipTextConfig:
    from physicedit_torch.io.convert import _layer_count

    g = lambda k: tuple(np.shape(sd[prefix + k]))
    vocab, hidden = g("embeddings.word_embeddings.weight")
    return BlipTextConfig(
        vocab_size=vocab, hidden_size=hidden,
        num_layers=_layer_count(sd, prefix + "encoder.layer."),
        num_heads=(num_heads if num_heads is not None
                   else {768: 12}.get(hidden, max(1, hidden // 64))),
        intermediate_size=g("encoder.layer.0.intermediate.dense.weight")[0],
        max_position=g("embeddings.position_embeddings.weight")[0],
        encoder_width=(encoder_width if encoder_width is not None
                       else g("encoder.layer.0.crossattention.self.key.weight")[1]))


def blip_text_from_torch(sd, prefix="", encoder_width=None, dtype=torch.float32,
                         num_heads=None, device="cuda"):
    """-> (BlipText on ``device``, cfg); the config from the shapes."""
    cfg = blip_text_config(sd, prefix, encoder_width, num_heads)
    return _load(materialize(BlipText(cfg, dtype), device), sd,
                 blip_text_key_map(cfg.num_layers, prefix)), cfg


# the published head's nn.Sequential indices (dropout slots in between)
IMAGEREWARD_MLP_INDICES = (0, 2, 4, 6, 7)


def imagereward_state_dict(model: ImageReward) -> dict:
    """``model`` in the published ImageReward.safetensors key space (views of
    its parameters), the layout :func:`imagereward_from_state_dict` reads."""
    rows = [("vit." + p, r) for p, r in blip_vit_key_map(model.vit.cfg.depth,
                                                         "blip.visual_encoder.")]
    rows += [("text." + p, r) for p, r in blip_text_key_map(model.text.cfg.num_layers,
                                                            "blip.text_encoder.")]
    for j, i in enumerate(IMAGEREWARD_MLP_INDICES[:len(model.mlp)]):
        _rows_lin(rows, f"mlp.{j}", f"mlp.layers.{i}")
    params = dict(model.named_parameters())
    return {r: params[p] for p, r in rows}


def imagereward_from_state_dict(sd, dtype=torch.float32, device="cuda"):
    """Published ImageReward.safetensors -> (ImageReward on ``device``,
    vit_cfg, txt_cfg).

    The MLP head's Sequential indices are {0, 2, 4, 6, 7} (dropout slots in
    between; its activations are commented out upstream)."""
    vit_cfg = blip_vit_config(sd, "blip.visual_encoder.")
    txt_cfg = blip_text_config(sd, "blip.text_encoder.", encoder_width=vit_cfg.width)
    idxs = sorted(int(k.split(".")[2]) for k in sd
                  if k.startswith("mlp.layers.") and k.endswith(".weight"))
    dims = [np.shape(sd[f"mlp.layers.{idxs[0]}.weight"])[1]]
    dims += [np.shape(sd[f"mlp.layers.{i}.weight"])[0] for i in idxs]
    rows = [("vit." + p, r) for p, r in blip_vit_key_map(vit_cfg.depth, "blip.visual_encoder.")]
    rows += [("text." + p, r) for p, r in
             blip_text_key_map(txt_cfg.num_layers, "blip.text_encoder.")]
    for j, i in enumerate(idxs):
        _rows_lin(rows, f"mlp.{j}", f"mlp.layers.{i}")
    model = materialize(ImageReward(vit_cfg, txt_cfg, tuple(dims), dtype), device)
    return _load(model, sd, rows), vit_cfg, txt_cfg


# CLIP-style normalisation for BLIP inputs (imagereward.py:16-22).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_blip(pil_image, size=224):
    """Resize(shorter->size, bicubic) + CenterCrop(size) + normalise ->
    [1, size, size, 3] float32 (the torchvision chain of imagereward.py,
    PIL / NumPy only)."""
    im = pil_image.convert("RGB")
    w, h = im.size
    scale = size / min(w, h)
    im = im.resize((max(size, int(round(w * scale))),
                    max(size, int(round(h * scale)))), resample=3)  # BICUBIC
    w, h = im.size
    left, top = (w - size) // 2, (h - size) // 2
    im = im.crop((left, top, left + size, top + size))
    x = np.asarray(im, np.float32) / 255.0
    return ((x - CLIP_MEAN) / CLIP_STD)[None]
