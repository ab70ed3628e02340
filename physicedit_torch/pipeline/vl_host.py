"""Host-side Qwen2.5-VL preprocessing: image patching, M-RoPE indices,
vision-feature scatter.  The port's own copy of
``physicedit_tpu/pipeline/vl_host.py``.

Pure NumPy/PIL code replicating the behaviour of the HF Qwen2VL processor
and Qwen2_5_VLModel.get_rope_index, so the device programs
(models/qwen_vl.py, models/qwen_vl_vision.py) see only dense arrays.

Reference conventions being reproduced:
- conditioning images are pre-resized to ~384-square area /32
  (qwen_image_physical.py:750-760) before the processor's own smart_resize
  to 28-pixel multiples,
- the edit prompt gains the 64 latent-transition special tokens as a suffix
  (qwen_image_physical.py:778-783).
"""

from __future__ import annotations

import math

import numpy as np

PATCH_SIZE = 14
MERGE_SIZE = 2
TEMPORAL_PATCH_SIZE = 2
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def calculate_dimensions(target_area: float, ratio: float) -> tuple[int, int]:
    """(width, height) with ~target_area, rounded to /32
    (qwen_image_physical.py:750-756)."""
    width = math.sqrt(target_area * ratio)
    height = width / ratio
    return round(width / 32) * 32, round(height / 32) * 32


def resize_vl_image(image, target_area: int = 384 * 384):
    """PIL resize used before the VL processor (qwen_image_physical.py:758)."""
    w, h = calculate_dimensions(target_area, image.size[0] / image.size[1])
    return image.resize((w, h))


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """HF Qwen2VL smart_resize: /28-divisible, pixel-count bounded."""
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def image_to_patches(image) -> tuple[np.ndarray, tuple[int, int, int]]:
    """One PIL image -> (flatten_patches [N, 1176], grid_thw).

    Replicates Qwen2VLImageProcessor._preprocess: bicubic resize to the
    smart size, scale 1/255, CLIP normalisation, temporal duplication to 2
    frames, and the (t, hblk, wblk, m, m, c, tp, p, p) flatten order.
    """
    from PIL import Image

    w, h = image.size
    rh, rw = smart_resize(h, w)
    img = image.convert("RGB").resize((rw, rh), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    arr = arr.transpose(2, 0, 1)  # CHW
    patches = np.stack([arr, arr])  # temporal duplication, [2, C, H, W]

    c = 3
    grid_t = 1
    gh, gw = rh // PATCH_SIZE, rw // PATCH_SIZE
    m, p = MERGE_SIZE, PATCH_SIZE
    patches = patches.reshape(grid_t, TEMPORAL_PATCH_SIZE, c,
                              gh // m, m, p, gw // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * gh * gw, c * TEMPORAL_PATCH_SIZE * p * p)
    return flat, (grid_t, gh, gw)


def images_to_patches(images) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
    flats, grids = [], []
    for im in images:
        f, g = image_to_patches(im)
        flats.append(f)
        grids.append(g)
    return np.concatenate(flats, 0), grids


def expand_image_pads(input_ids: list[int], grids, image_pad_id: int) -> list[int]:
    """Replace each single <|image_pad|> with grid_t*gh*gw/4 copies (the
    processor-side token expansion)."""
    out = []
    img_i = 0
    for tok in input_ids:
        if tok == image_pad_id:
            t, h, w = grids[img_i]
            out.extend([image_pad_id] * (t * (h // MERGE_SIZE) * (w // MERGE_SIZE)))
            img_i += 1
        else:
            out.append(tok)
    return out


def get_rope_index(input_ids: np.ndarray, grids,
                   image_token_id: int, vision_start_token_id: int,
                   tokens_per_second: int = 2) -> np.ndarray:
    """[S] token ids (single unpadded sequence) -> [3, S] position ids.

    Images-only port of Qwen2_5_VLModel.get_rope_index (modeling:956-1070):
    text spans advance all three components together; each image block gets
    (t const, h grid, w grid) offset past the preceding text.
    """
    toks = input_ids.tolist()
    pos_list = []
    st = 0
    img_i = 0
    while img_i < len(grids):
        try:
            ed = toks.index(image_token_id, st)
        except ValueError:
            break
        t, h, w = grids[img_i]
        lh, lw = h // MERGE_SIZE, w // MERGE_SIZE
        st_idx = pos_list[-1].max() + 1 if pos_list else 0
        text_len = ed - st
        pos_list.append(np.tile(np.arange(text_len), (3, 1)) + st_idx)
        t_idx = np.repeat(np.arange(t) * tokens_per_second, lh * lw)
        h_idx = np.tile(np.repeat(np.arange(lh), lw), t)
        w_idx = np.tile(np.arange(lw), t * lh)
        pos_list.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
        st = ed + t * lh * lw
        img_i += 1
    if st < len(toks):
        st_idx = pos_list[-1].max() + 1 if pos_list else 0
        pos_list.append(np.tile(np.arange(len(toks) - st), (3, 1)) + st_idx)
    return np.concatenate(pos_list, axis=1)


def scatter_vision_features(token_embeds: np.ndarray, input_ids: np.ndarray,
                            vision_features: np.ndarray, image_token_id: int):
    """Replace image-pad token embeddings with vision features, in order."""
    out = np.array(token_embeds)
    mask = input_ids == image_token_id
    assert mask.sum() == vision_features.shape[0], (
        f"{mask.sum()} image tokens vs {vision_features.shape[0]} features")
    out[mask] = vision_features
    return out


def bucket_pad_text(embs: list, bucket: int) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad text rows to a shared /bucket length; build the key mask.

    Rounding the longest row up to ``bucket`` lets varying prompt lengths
    reuse the same compiled denoise/train program, and key-side masking
    keeps the padded form mathematically identical to the unpadded one.
    The single implementation for single-edit, batched serving, and the
    trainer (the bucket SIZE may differ per caller, the contract may not).

    Returns (prompt_emb [B, S, D] float32, txt_mask [B, S] bool).
    """
    s_t = max(e.shape[0] for e in embs)
    s_t = ((s_t + bucket - 1) // bucket) * bucket
    b = len(embs)
    prompt_emb = np.zeros((b, s_t, embs[0].shape[1]), np.float32)
    txt_mask = np.zeros((b, s_t), bool)
    for i, e in enumerate(embs):
        prompt_emb[i, : e.shape[0]] = e
        txt_mask[i, : e.shape[0]] = True
    return prompt_emb, txt_mask
