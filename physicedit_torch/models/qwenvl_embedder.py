"""Qwen2.5-VL prompt-enhancement embedder
(``physicedit_tpu/models/qwenvl_embedder.py``).

The reference's ``Qwen25VL_7b_Embedder``: it encodes a caption and a
reference image through Qwen2.5-VL with a fixed prompt-enhancement
instruction prefix and returns fixed-length (640) last-hidden-state buffers
and masks for a downstream generator (Nexus-Gen).

Reference quirks reproduced:
- quotes in the rendered chat string are re-tokenized char by char (the
  ``split_string`` surgery: quoted spans after char 155 become per-character
  CJK-quoted segments so the tokenizer cannot merge them), and the
  re-tokenized text segment is spliced onto the original ids at the first
  ``<|vision_end|>`` (151653);
- hidden states are taken from position 217 on (the tokenized prefix and
  chat scaffolding) and right-padded / truncated to 640.

The tokenizer / processor is injectable.  :func:`embed` runs the port's
``QwenVLText.text_forward``, so the card takes kernel K2 in every layer.
Deviation D5: the JAX package scatters the image features on the host in
fp32 and feeds that fp32 embedding to its decoder, whose ``x @ w`` promotes,
so over bf16 weights its activations are fp32 all the way; here the
features replace the image-pad rows on the model's device, in the model's
dtype (:func:`models.nexus_gen.replace_image_rows`; K2 takes bf16 only, and
a bf16 ``nn.Linear`` takes no fp32 input), so a bf16 model runs bf16
activations.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_LENGTH = 640
PREFIX_TOKEN_OFFSET = 217          # qwenvl.py:160-165
VISION_END_ID = 151653
IMAGE_TOKEN_ID = 151655
VISION_START_ID = 151652

# Behavioral constant — must match the reference verbatim (qwenvl.py:23-32).
QWEN25VL_7B_PREFIX = '''Given a user prompt, generate an "Enhanced prompt" that provides detailed visual descriptions suitable for image generation. Evaluate the level of detail in the user prompt:
- If the prompt is simple, focus on adding specifics about colors, shapes, sizes, textures, and spatial relationships to create vivid and concrete scenes.
- If the prompt is already detailed, refine and enhance the existing details slightly without overcomplicating.\n
Here are examples of how to transform or refine prompts:
- User Prompt: A cat sleeping -> Enhanced: A small, fluffy white cat curled up in a round shape, sleeping peacefully on a warm sunny windowsill, surrounded by pots of blooming red flowers.
- User Prompt: A busy city street -> Enhanced: A bustling city street scene at dusk, featuring glowing street lamps, a diverse crowd of people in colorful clothing, and a double-decker bus passing by towering glass skyscrapers.\n
Please generate only the enhanced description for the prompt below and avoid including any additional commentary or evaluations:
User Prompt:'''


def split_string(s: str) -> list:
    """Reference qwenvl.py:145-170: normalize quotes to english double
    quotes, then split the string so that each quoted character past
    index 155 becomes its own CJK-quoted segment."""
    s = s.replace("“", '"').replace("”", '"').replace("'", '"')
    result = []
    in_quotes = False
    temp = ""
    for idx, char in enumerate(s):
        if char == '"' and idx > 155:
            temp += char
            if not in_quotes:
                result.append(temp)
                temp = ""
            in_quotes = not in_quotes
            continue
        if in_quotes:
            if char.isspace():
                pass  # have space token
            result.append("“" + char + "”")
        else:
            temp += char
    if temp:
        result.append(temp)
    return result


def retokenize_with_quote_splice(input_ids, text: str, tokenize_fn):
    """Reference qwenvl.py:137-160: re-tokenize `text` segment-by-segment
    (dropping the CJK quote marks 2073/854 the per-char segments pick up),
    then splice: original ids up to the first <|vision_end|> + re-tokenized
    ids from ITS first <|vision_end|>.

    tokenize_fn: str -> list[int] (no special tokens added).
    """
    token_list = []
    for seg in split_string(text):
        toks = tokenize_fn(seg)
        if len(toks) >= 2 and toks[0] == 2073 and toks[-1] == 854:
            toks = toks[1:-1]
        token_list.extend(toks)
    old = list(input_ids)
    idx1 = old.index(VISION_END_ID)
    idx2 = token_list.index(VISION_END_ID)
    return old[:idx1] + token_list[idx2:]


def extract_embeddings(hidden, max_length: int = MAX_LENGTH,
                       offset: int = PREFIX_TOKEN_OFFSET):
    """Last-hidden states [1, S, D] -> fixed ([1, max_length, D] buffer,
    [1, max_length] int mask) per the reference layout (qwenvl.py:160-167:
    positions `offset:` copied in, zero-padded, ones mask over the copied
    span)."""
    s, d = hidden.shape[1], hidden.shape[2]
    n = max(min(max_length, s - offset), 0)
    emb = hidden.new_zeros((1, max_length, d))
    emb[:, :n] = hidden[:, offset:offset + n]
    mask = torch.zeros((1, max_length), dtype=torch.int32, device=hidden.device)
    mask[:, :n] = 1
    return emb, mask


@torch.no_grad()
def embed(text, input_ids, vision_embeds, grids, max_length: int = MAX_LENGTH):
    """Put the image features in the image-pad rows (their count must equal
    the pads'), run the decoder, extract the fixed-length enhancement
    embedding.

    text: a ``models.qwen_vl.QwenVLText``; input_ids: [1, S] (quote-spliced,
    image pads expanded); vision_embeds: [n_img, D] merged ViT features;
    grids: per-image (t, h, w).  Returns (emb [1, max_length, D] in the
    model's dtype, mask [1, max_length] int32) on the model's device.
    """
    from physicedit_torch.models.nexus_gen import replace_image_rows
    from physicedit_torch.pipeline.vl_host import get_rope_index

    ids = np.asarray(input_ids)
    dev = text.norm.scale.device
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
    vis = torch.as_tensor(vision_embeds).to(dev, torch.float32)
    n_pad = int((ids == IMAGE_TOKEN_ID).sum())
    assert n_pad == vis.shape[0], f"{n_pad} image tokens vs {vis.shape[0]} features"
    # D5: the fp32 features enter the decoder in the model's dtype
    emb_in = replace_image_rows(text.embed_tokens(ids_t), ids_t, vis[None])
    pos = torch.from_numpy(get_rope_index(ids[0], grids, IMAGE_TOKEN_ID, VISION_START_ID))
    mask = torch.ones(ids.shape, dtype=torch.bool, device=dev)
    hidden = text.text_forward(emb_in, pos[:, None].to(dev), mask)
    return extract_embeddings(hidden, max_length)
