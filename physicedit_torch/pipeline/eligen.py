"""EliGen entity control: the attention bias, built on the host in NumPy
(``physicedit_tpu/pipeline/eligen.py``).

- The text stream becomes [entity_1 .. entity_N, global] prompt embeddings
  on one sequence axis.
- Each entity's prompt tokens see only the image tokens whose 2x2 patch
  overlaps the entity's spatial mask, and those image tokens see them; the
  global prompt sees every image token.
- Different prompt segments do not see each other.
- The text RoPE restarts at ``max_vid_index`` for every segment
  (``ops/rope.max_vid_index_of``, ``text_rope_tables``).

The DiT consumes the bias through kernel K7
(``kernels/flash_attention.fixedmax_attention_bias``).
"""

from __future__ import annotations

import numpy as np

NEG = -1e30


def patch_presence(mask_latent: np.ndarray) -> np.ndarray:
    """[h, w] bool latent-resolution mask -> [h/2 * w/2] per-token presence
    (any active pixel in the token's 2x2 patch)."""
    h, w = mask_latent.shape
    return mask_latent.reshape(h // 2, 2, w // 2, 2).any(axis=(1, 3)).reshape(-1)


def build_entity_bias(entity_masks_latent: list, seq_lens: list,
                      image_seq_len: int, base_image_tokens: int) -> np.ndarray:
    """Additive attention bias [S, S] fp32 (0 allowed, NEG blocked) over the
    unpadded joint sequence [text segments, image tokens].

    entity_masks_latent: per-entity [h, w] bool at latent resolution.
    seq_lens: text lengths [entity_1 .. entity_N, global].
    image_seq_len: all image tokens (base and any edit / context images).
    base_image_tokens: tokens of the base grid; the masks tile over the
    extra image tokens, which must be a whole multiple of it.
    """
    n_prompts = len(seq_lens)
    if n_prompts != len(entity_masks_latent) + 1:
        raise ValueError("seq_lens must be the entity segments and then the global prompt")
    txt_total = int(np.sum(seq_lens))
    total = txt_total + image_seq_len
    allow = np.ones((total, total), bool)
    starts = np.concatenate([[0], np.cumsum(seq_lens)]).astype(int)
    if image_seq_len % base_image_tokens:
        raise ValueError(
            f"EliGen entity masks need the joint image sequence ({image_seq_len} tokens) "
            f"to be a whole multiple of the base grid ({base_image_tokens}): give "
            f"edit/context images the output resolution")
    repeat = image_seq_len // base_image_tokens
    presence = [np.tile(patch_presence(m), repeat) for m in entity_masks_latent]
    presence.append(np.ones(image_seq_len, bool))       # the global prompt sees all

    for i in range(n_prompts):
        p0, p1 = starts[i], starts[i + 1]
        allow[p0:p1, txt_total:] = presence[i][None, :]
        allow[txt_total:, p0:p1] = presence[i][:, None]
    for i in range(n_prompts):
        for j in range(n_prompts):
            if i != j:
                allow[starts[i]:starts[i + 1], starts[j]:starts[j + 1]] = False
    return np.where(allow, 0.0, NEG).astype(np.float32)


def downsample_entity_mask(mask_image, lat_h: int, lat_w: int) -> np.ndarray:
    """PIL mask -> [lat_h, lat_w] bool (nearest resize, > 127)."""
    from PIL import Image

    m = mask_image.convert("L").resize((lat_w, lat_h), Image.NEAREST)
    return np.asarray(m) > 127
