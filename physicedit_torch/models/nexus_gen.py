"""Nexus-Gen, the autoregressive image-editing model
(``physicedit_tpu/models/nexus_gen.py``).

A Qwen2.5-VL-7B decoder (:class:`models.qwen_vl.QwenVLText`) with two extra
heads:

- ``vision_head``: Linear(hidden, hidden, bias=False) emitting predicted
  image embeddings at every position;
- ``image_prefill_embeds``: [81, hidden] learned queries standing in for the
  81 target-image tokens.

The path the reference's registry exposes is the teacher-forced single
forward: build a chat with the instruction (and a reference image), replace
the image-pad positions by the reference image's ViT features and then the
81 prefill queries, run the causal decoder once (kernel K2 in every layer on
the card), and read ``vision_head`` at the positions *preceding* each
target-image token (the shift by one).  The reference fork's incremental
``.generate`` is used by no pipeline and is not ported, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from physicedit_torch.core.params import linear, materialize
from physicedit_torch.models.qwen_vl import QWEN25_VL_7B_TEXT, QwenVLText, QwenVLTextConfig

NUM_IMG_TOKENS = 81            # 252x252 white target @ patch 14, merge 2
IMAGE_TOKEN_ID = 151655
VISION_START_ID = 151652
VISION_END_ID = 151653


class NexusGen(nn.Module):
    """The decoder and its two heads, named as the JAX tree's keys.  Built on
    the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, cfg: QwenVLTextConfig = QWEN25_VL_7B_TEXT, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.text = QwenVLText(cfg, dtype)
        self.vision_head = linear(d, d, bias=False, dtype=dtype)
        self.image_prefill_embeds = nn.Parameter(
            torch.empty(NUM_IMG_TOKENS, d, dtype=dtype, device="meta"), requires_grad=False)


@torch.no_grad()
def init_nexus_gen_(model: NexusGen, generator: torch.Generator) -> NexusGen:
    """Random weights: linears as ``core/params.init_random_``, RMSNorm gains
    one, the token table and the prefill queries N(0, 0.02^2)."""
    from physicedit_torch.core.params import init_random_

    init_random_(model, generator)
    model.text.embed.normal_(0.0, 0.02, generator=generator)
    model.image_prefill_embeds.normal_(0.0, 0.02, generator=generator)
    return model


def replace_image_rows(emb, input_ids, image_table):
    """The reference's masked_scatter as an ordinal gather: the image-pad
    positions of ``input_ids`` [B, S] take the rows of ``image_table``
    [B, n, D] in order (``cumsum - 1``, clipped to n), cast to ``emb``'s
    dtype; ``emb`` [B, S, D] keeps every other row."""
    if image_table.shape[1] == 0:
        return emb
    mask = input_ids == IMAGE_TOKEN_ID
    ordinal = (mask.long().cumsum(1) - 1).clamp(0, image_table.shape[1] - 1)
    gathered = torch.gather(image_table, 1,
                            ordinal[..., None].expand(-1, -1, image_table.shape[-1]))
    return torch.where(mask[..., None], gathered.to(emb.dtype), emb)


def _hidden(model: NexusGen, input_ids, attn_mask, position_ids, image_table):
    text = model.text
    emb = replace_image_rows(text.embed_tokens(input_ids), input_ids, image_table)
    return text.text_forward(emb, position_ids, attn_mask)


@torch.no_grad()
def nexus_forward(model: NexusGen, input_ids, attn_mask, position_ids, image_table):
    """Teacher-forced forward -> (lm logits, vision_head embeddings).

    input_ids: [B, S]; position_ids: [3, B, S]; attn_mask: [B, S] bool;
    image_table: [B, n, D], the replacement embeddings of the image-pad
    positions in order (input image features, then the 81 prefill queries):
    the reference's masked_scatter as an ordinal gather, ``cumsum - 1``
    clipped to the table's length.
    """
    hidden = _hidden(model, input_ids, attn_mask, position_ids, image_table)
    return model.text.lm_head(hidden), model.vision_head(hidden)


def editing_messages(instruction: str) -> list:
    """nexus_gen.py:90-95."""
    if "<image>" not in instruction:
        instruction = "<image> " + instruction
    return [{"role": "user", "content": instruction},
            {"role": "assistant", "content": "Here is the image: <image>"}]


def generation_messages(instruction: str) -> list:
    """nexus_gen.py:97-100."""
    return [{"role": "user", "content":
             f"Generate an image according to the following description: "
             f"{instruction}"},
            {"role": "assistant", "content":
             "Here is an image based on the description: <image>"}]


@torch.no_grad()
def target_embeddings(model: NexusGen, input_ids, input_image_embeds, grids) -> torch.Tensor:
    """Predicted embeddings for the target image (nexus_gen.py:116-152).

    input_ids: [1, S] with the image-pad runs already expanded (the LAST
    run is the 81-token target); input_image_embeds: [n_in, D] ViT features
    of the reference image(s) (an empty array for text-to-image); grids:
    (t, h, w) per image INCLUDING the target, for the M-RoPE indices.
    Returns [81, D]: the vision_head outputs at the positions that predict
    each target-image token.
    """
    from physicedit_torch.pipeline.vl_host import get_rope_index

    ids = np.asarray(input_ids)
    assert ids.shape[0] == 1, "reference path is single-sample"
    dev = model.image_prefill_embeds.device
    d = model.cfg.hidden_size
    vis = torch.as_tensor(input_image_embeds).to(dev, torch.float32).reshape(-1, d)
    table = torch.cat([vis, model.image_prefill_embeds.float()])[None]
    position_ids = torch.from_numpy(get_rope_index(ids[0], grids, IMAGE_TOKEN_ID,
                                                   VISION_START_ID))[:, None].to(dev)
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
    hidden = _hidden(model, ids_t, torch.ones(ids.shape, dtype=torch.bool, device=dev),
                     position_ids, table)
    # positions whose NEXT token is a target-image token predict it
    gt_pos = np.nonzero(ids[0] == IMAGE_TOKEN_ID)[0][-NUM_IMG_TOKENS:]
    return model.vision_head(hidden[0, torch.from_numpy(gt_pos - 1).to(dev)])


# ---------------------------------------------------------------------------
# Conversion (registry hash 2bd19e845116e4f875a0a048e27fc219)
# ---------------------------------------------------------------------------

def nexus_text_config(sd: dict) -> QwenVLTextConfig:
    """Qwen2.5-VL-7B's config with the widths and depth of a raw Nexus-Gen
    state dict (``model.*`` keys), Qwen2.5-VL's head_dim kept."""
    from physicedit_torch.io.convert import _layer_count

    base = QWEN25_VL_7B_TEXT
    vocab, d = np.shape(sd["model.embed_tokens.weight"])
    return dataclasses.replace(
        base, hidden_size=d, vocab_size=vocab,
        num_layers=_layer_count(sd, "model.layers."),
        num_heads=np.shape(sd["model.layers.0.self_attn.q_proj.weight"])[0] // base.head_dim,
        num_kv_heads=np.shape(sd["model.layers.0.self_attn.k_proj.weight"])[0] // base.head_dim,
        intermediate_size=np.shape(sd["model.layers.0.mlp.gate_proj.weight"])[0])


def nexus_llm_from_torch(sd: dict, cfg: QwenVLTextConfig | None = None,
                         dtype=torch.bfloat16, device="cuda") -> NexusGen:
    """Raw Nexus-Gen checkpoint -> :class:`NexusGen`.  The checkpoint uses
    HF-fork keys (``model.layers.* visual.* lm_head.* vision_head.*
    image_prefill_embeds.*``), remapped as the text encoder's are
    (``io/convert.remap_text_encoder_keys``) onto the Qwen2.5-VL key map.
    ``cfg`` defaults to :func:`nexus_text_config`."""
    from physicedit_torch.io.convert import (COPY, load_module_, remap_text_encoder_keys,
                                             text_key_map)

    cfg = nexus_text_config(sd) if cfg is None else cfg
    sd = {k: torch.as_tensor(v) for k, v in remap_text_encoder_keys(sd).items()}
    rows = [(f"text.{p}", keys, kind)
            for p, keys, kind in text_key_map(cfg.num_layers, "model.language_model.")]
    rows += [("vision_head.weight", ("vision_head.weight",), COPY),
             ("image_prefill_embeds", ("image_prefill_embeds.weight",), COPY)]
    return load_module_(materialize(NexusGen(cfg, dtype), device), sd, rows).eval()


def nexus_vision_from_torch(sd: dict, cfg=None, dtype=torch.bfloat16, device="cuda"):
    """The checkpoint's ``visual.*`` ViT -> ``models.qwen_vl_vision.QwenVLVision``
    (``cfg`` defaults to Qwen2.5-VL-7B's with the checkpoint's depth)."""
    from physicedit_torch.io.convert import qwen_vl_vision_from_state_dict

    return qwen_vl_vision_from_state_dict(sd, cfg, dtype, device)


def nexus_gen_state_dict(model: NexusGen, vision) -> dict:
    """``model`` and its ViT in the raw checkpoint's key space (``model.*``,
    ``visual.*``, ``lm_head.*``, ``vision_head.*``,
    ``image_prefill_embeds.*``), the layout :func:`load_nexus_gen` reads."""
    from physicedit_torch.io.convert import text_encoder_to_state_dict

    return {**text_encoder_to_state_dict(model.text, vision),
            "vision_head.weight": model.vision_head.weight,
            "image_prefill_embeds.weight": model.image_prefill_embeds}


def load_nexus_gen(path: str, dtype=torch.bfloat16, device="cuda", text_cfg=None,
                   vision_cfg=None):
    """Load a Nexus-Gen checkpoint file -> (NexusGen, QwenVLVision) on
    ``device``."""
    from physicedit_torch.io.safetensors_io import load_state_dict

    sd = load_state_dict(path)
    return (nexus_llm_from_torch(sd, text_cfg, dtype, device),
            nexus_vision_from_torch(sd, vision_cfg, dtype, device))
