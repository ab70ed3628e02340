"""OpenCLIP (ViT-H/14-class) dual towers for HPSv2 / CLIPScore
(``physicedit_tpu/models/openclip.py``).

The network the HPSv2 / HPSv2.1 / CLIP preference scorers wrap through the
vendored ``open_clip`` package:

- vision: pre-LN ViT, ``conv1`` with no bias, a class token, ``ln_pre``, the
  resblocks (x += attn(ln_1 x); x += mlp(ln_2 x)), ``ln_post`` on the CLS
  token, then ``@ proj``;
- text: token + positional embeddings, causally masked resblocks (a
  ``-inf`` bias), ``ln_final``, pooled at the argmax token id (the EOT token
  has the highest id in the CLIP BPE vocab), then ``@ text_projection``;
- score: cosine(image, text), the raw diagonal of normalised feature
  products, no logit scale.

Attention is the dense :func:`ops.attention.sdpa_xla` (the JAX package runs
it with no Pallas kernel too); GELU is exact unless ``quick_gelu``.  Pixels
are NHWC, as in the JAX package.  Weights load from the published open_clip
state-dict key space (``HPS_v2_compressed.safetensors``) through
:func:`openclip_from_state_dict`.
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

# Vision-tower head counts by width (open_clip model registry values; the
# text tower is always width // 64).
_VISION_HEADS = {768: 12, 1024: 16, 1280: 16, 1408: 16, 1664: 16}


@dataclasses.dataclass(frozen=True)
class OpenClipTowerConfig:
    width: int
    layers: int
    heads: int
    patch_size: int = 14           # vision only
    context_length: int = 77       # text only
    quick_gelu: bool = False       # True only for original-OpenAI weights
    eps: float = 1e-5
    mlp_ratio: int = 4             # the resblocks' c_fc width over the tower's
    image_size: int = 224          # vision only: sets the positional table
    output_dim: int = 1024         # proj / text_projection columns

    @property
    def head_dim(self):
        return self.width // self.heads


# ViT-H/14 (laion2B): the tower under HPSv2/v2.1/PickScore/MPS.
VIT_H_14_VISION = OpenClipTowerConfig(width=1280, layers=32, heads=16)
VIT_H_14_TEXT = OpenClipTowerConfig(width=1024, layers=24, heads=16)
VIT_H_14_VOCAB = 49408


def _ln(d, dtype):
    return Leaf(scale=(d,), bias=(d,), dtype=dtype)


class ResBlock(nn.Module):
    def __init__(self, cfg: OpenClipTowerConfig, dtype=None):
        super().__init__()
        d, h = cfg.width, cfg.width * cfg.mlp_ratio
        self.cfg = cfg
        self.ln_1 = _ln(d, dtype)
        self.qkv = linear(d, 3 * d, dtype=dtype)
        self.out = linear(d, d, dtype=dtype)
        self.ln_2 = _ln(d, dtype)
        self.c_fc = linear(d, h, dtype=dtype)
        self.c_proj = linear(h, d, dtype=dtype)

    def forward(self, x, bias=None):
        cfg = self.cfg
        b, s, d = x.shape
        h = layer_norm(x, cfg.eps, self.ln_1.scale, self.ln_1.bias)
        q, k, v = self.qkv(h).reshape(b, s, 3, cfg.heads, cfg.head_dim).unbind(2)
        x = x + self.out(sdpa_xla(q, k, v, bias=bias).reshape(b, s, d))
        h = self.c_fc(layer_norm(x, cfg.eps, self.ln_2.scale, self.ln_2.bias))
        h = h * torch.sigmoid(1.702 * h) if cfg.quick_gelu else F.gelu(h)
        return x + self.c_proj(h)


class OpenClipVision(nn.Module):
    def __init__(self, cfg: OpenClipTowerConfig, dtype=None):
        super().__init__()
        d, ps = cfg.width, cfg.patch_size
        n_pos = (cfg.image_size // ps) ** 2 + 1
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, d, ps, ps, bias=False, dtype=dtype, device="meta")
        self.class_embedding = nn.Parameter(torch.empty(d, dtype=dtype, device="meta"))
        self.positional_embedding = nn.Parameter(torch.empty(n_pos, d, dtype=dtype,
                                                             device="meta"))
        self.ln_pre = _ln(d, dtype)
        self.blocks = nn.ModuleList(ResBlock(cfg, dtype) for _ in range(cfg.layers))
        self.ln_post = _ln(d, dtype)
        self.proj = nn.Parameter(torch.empty(d, cfg.output_dim, dtype=dtype, device="meta"))


class OpenClipText(nn.Module):
    def __init__(self, cfg: OpenClipTowerConfig, vocab_size: int = VIT_H_14_VOCAB, dtype=None):
        super().__init__()
        d = cfg.width
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, d, dtype=dtype,
                                                        device="meta"))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, d,
                                                             dtype=dtype, device="meta"))
        self.blocks = nn.ModuleList(ResBlock(cfg, dtype) for _ in range(cfg.layers))
        self.ln_final = _ln(d, dtype)
        self.text_projection = nn.Parameter(torch.empty(d, cfg.output_dim, dtype=dtype,
                                                        device="meta"))


class OpenClip(nn.Module):
    """Both towers; children named as the JAX tree's ``visual`` / ``text``.
    Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, vision_cfg: OpenClipTowerConfig = VIT_H_14_VISION,
                 text_cfg: OpenClipTowerConfig = VIT_H_14_TEXT,
                 vocab_size: int = VIT_H_14_VOCAB, dtype=None):
        super().__init__()
        self.visual = OpenClipVision(vision_cfg, dtype)
        self.text = OpenClipText(text_cfg, vocab_size, dtype)


@torch.no_grad()
def init_openclip_(model: OpenClip, generator: torch.Generator) -> OpenClip:
    """Random weights (tests, the card's smoke): linears and ``conv1`` as
    ``core/params.init_random_``, LayerNorms 1 / 0, the embeddings and
    projections N(0, 0.02^2)."""
    from physicedit_torch.core.params import init_random_

    init_random_(model, generator)
    for p in (model.visual.class_embedding, model.visual.positional_embedding,
              model.visual.proj, model.text.token_embedding,
              model.text.positional_embedding, model.text.text_projection):
        p.normal_(0.0, 0.02, generator=generator)
    return model


@torch.no_grad()
def clip_image_features(visual: OpenClipVision, pixels: torch.Tensor) -> torch.Tensor:
    """CLIP-normalised pixels [B, H, W, 3] -> projected features [B, out]
    (open_clip ``VisionTransformer.forward``)."""
    cfg = visual.cfg
    x = visual.conv1(pixels.permute(0, 3, 1, 2).to(visual.conv1.weight.dtype))
    x = x.flatten(2).transpose(1, 2)
    cls = visual.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + visual.positional_embedding.to(x.dtype)
    x = layer_norm(x, cfg.eps, visual.ln_pre.scale, visual.ln_pre.bias)
    for block in visual.blocks:
        x = block(x)
    pooled = layer_norm(x[:, 0], cfg.eps, visual.ln_post.scale, visual.ln_post.bias)
    return pooled @ visual.proj.to(pooled.dtype)


@torch.no_grad()
def clip_text_features(text: OpenClipText, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids [B, S] -> projected features [B, out], pooled at the argmax
    id: the EOT token (open_clip ``CLIP.encode_text``)."""
    cfg = text.cfg
    b, s = input_ids.shape
    ids = input_ids.long()
    x = text.token_embedding[ids] + text.positional_embedding[None, :s]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    bias = torch.where(causal, 0.0, float("-inf"))[None, None]
    for block in text.blocks:
        x = block(x, bias)
    x = layer_norm(x, cfg.eps, text.ln_final.scale, text.ln_final.bias)
    pooled = x[torch.arange(b, device=x.device), ids.argmax(-1)]
    return pooled @ text.text_projection.to(pooled.dtype)


@torch.no_grad()
def clip_similarity(model: OpenClip, pixels: torch.Tensor,
                    input_ids: torch.Tensor) -> torch.Tensor:
    """diag(normalize(img) @ normalize(txt).T): the HPS / CLIP score (no
    logit scale, as the reference)."""
    img = clip_image_features(model.visual, pixels)
    txt = clip_text_features(model.text, input_ids)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return (img * txt).sum(-1)


# ---------------------------------------------------------------------------
# Weight conversion (open_clip state-dict key space)
# ---------------------------------------------------------------------------

def _resblock_rows(prefix: str, n: int) -> list:
    rows = []
    for i in range(n):
        p, r = f"blocks.{i}", f"{prefix}{i}"
        for ln in ("ln_1", "ln_2"):
            rows += [(f"{p}.{ln}.scale", f"{r}.{ln}.weight"), (f"{p}.{ln}.bias", f"{r}.{ln}.bias")]
        # nn.MultiheadAttention: a fused in_proj [3W, W] and out_proj
        rows += [(f"{p}.qkv.weight", f"{r}.attn.in_proj_weight"),
                 (f"{p}.qkv.bias", f"{r}.attn.in_proj_bias")]
        for name, ref in (("out", "attn.out_proj"), ("c_fc", "mlp.c_fc"),
                          ("c_proj", "mlp.c_proj")):
            rows += [(f"{p}.{name}.weight", f"{r}.{ref}.weight"),
                     (f"{p}.{name}.bias", f"{r}.{ref}.bias")]
    return rows


def openclip_key_map(vision_layers: int, text_layers: int) -> list:
    """(port parameter, open_clip key) pairs, every tensor copied as is."""
    rows = [("visual.conv1.weight", "visual.conv1.weight"),
            ("visual.class_embedding", "visual.class_embedding"),
            ("visual.positional_embedding", "visual.positional_embedding"),
            ("visual.proj", "visual.proj")]
    for ln in ("ln_pre", "ln_post"):
        rows += [(f"visual.{ln}.scale", f"visual.{ln}.weight"),
                 (f"visual.{ln}.bias", f"visual.{ln}.bias")]
    rows += [(f"visual.{p}", r) for p, r in
             _resblock_rows("visual.transformer.resblocks.", vision_layers)]
    rows += [("text.token_embedding", "token_embedding.weight"),
             ("text.positional_embedding", "positional_embedding"),
             ("text.ln_final.scale", "ln_final.weight"), ("text.ln_final.bias", "ln_final.bias"),
             ("text.text_projection", "text_projection")]
    rows += [(f"text.{p}", r) for p, r in _resblock_rows("transformer.resblocks.", text_layers)]
    return rows


def openclip_from_state_dict(sd, dtype=torch.float32, quick_gelu=False, vision_heads=None,
                             text_heads=None, device="cuda"):
    """open_clip CLIP state dict -> (OpenClip on ``device``, vision_cfg,
    text_cfg).  Configs are inferred from shapes; head counts come from
    the registry table (``_VISION_HEADS`` / width // 64) unless given."""
    from physicedit_torch.io.convert import COPY, _layer_count, load_module_

    g = lambda k: tuple(np.shape(sd[k]))
    v_width, _, patch, _ = g("visual.conv1.weight")
    v_layers = _layer_count(sd, "visual.transformer.resblocks.")
    t_vocab, t_width = g("token_embedding.weight")
    t_layers = _layer_count(sd, "transformer.resblocks.")
    n_pos = g("visual.positional_embedding")[0]
    vision_cfg = OpenClipTowerConfig(
        width=v_width, layers=v_layers,
        heads=(vision_heads if vision_heads is not None
               else _VISION_HEADS.get(v_width, max(1, v_width // 64))),
        patch_size=patch, quick_gelu=quick_gelu,
        mlp_ratio=g("visual.transformer.resblocks.0.mlp.c_fc.weight")[0] // v_width,
        image_size=int(round((n_pos - 1) ** 0.5)) * patch, output_dim=g("visual.proj")[1])
    text_cfg = OpenClipTowerConfig(
        width=t_width, layers=t_layers,
        heads=text_heads if text_heads is not None else max(1, t_width // 64),
        context_length=g("positional_embedding")[0], quick_gelu=quick_gelu,
        mlp_ratio=g("transformer.resblocks.0.mlp.c_fc.weight")[0] // t_width,
        output_dim=g("text_projection")[1])
    model = materialize(OpenClip(vision_cfg, text_cfg, t_vocab, dtype), device)
    rows = [(p, (r,), COPY) for p, r in openclip_key_map(v_layers, t_layers)]
    tensors = {r: torch.as_tensor(sd[r]) for _, (r,), _ in rows}
    return load_module_(model, tensors, rows).eval(), vision_cfg, text_cfg


def openclip_state_dict(model: OpenClip) -> dict:
    """``model`` in the open_clip key space (views of its parameters), the
    layout :func:`openclip_from_state_dict` reads."""
    params = dict(model.named_parameters())
    return {r: params[p] for p, r in openclip_key_map(len(model.visual.blocks),
                                                      len(model.text.blocks))}


# CLIP preprocessing constants (same normalisation as BLIP).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_clip(pil_image, size=224):
    """Resize(shorter->size, bicubic) + CenterCrop + normalise ->
    [1, size, size, 3] float32 (open_clip image_transform eval chain)."""
    im = pil_image.convert("RGB")
    w, h = im.size
    scale = size / min(w, h)
    im = im.resize((max(size, int(round(w * scale))),
                    max(size, int(round(h * scale)))), resample=3)
    w, h = im.size
    left, top = (w - size) // 2, (h - size) // 2
    im = im.crop((left, top, left + size, top + size))
    x = np.asarray(im, np.float32) / 255.0
    return ((x - CLIP_MEAN) / CLIP_STD)[None]
