"""The PhysicEdit edit pipeline on PyTorch
(``physicedit_tpu/pipeline/edit_pipeline.py``): image + instruction ->
edited image, through the single-image edit path.

Stages: VAE-encode the edit image; run the vision tower once and share its
features; the Qwen2.5-VL reasoner writes the physical-transition text
(prefill + greedy decode); encode the CFG positive and negative prompts with
the 64 special tokens; denoise over the DiT with the per-step special-token
rewrite; VAE-decode.  Host-side string and geometry work lives in this
package's copies of the JAX package's ``pipeline/prompt.py``,
``pipeline/vl_host.py`` and ``sampling/flow_match.py``.

Each call leaves its stage times, on the host clock around work that ends in
a device synchronise, in ``self.timings`` (milliseconds), beside the token
counts that set the stages' shapes.

:meth:`PhysicEditPipeline.quantize_` turns a loaded pipeline into the JAX
package's ``quantize="int4"`` serving lane, in place.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from physicedit_torch.kernels.quant_matmul import DIT_OUTER_KEYS, quantize_module_int4
from physicedit_torch.models import vae as m_vae
from physicedit_torch.models.dit import DiT, attn_clamp_needed
from physicedit_torch.models.qwen_vl import (QwenVLText, fuse_decode_projections,
                                             quantize_embedding_int8)
from physicedit_torch.models.qwen_vl_vision import QwenVLVision
from physicedit_torch.ops import rope as m_rope
from physicedit_torch.ops.patchify import patchify
from physicedit_torch.pipeline import prompt as P
from physicedit_torch.pipeline import vl_host
from physicedit_torch.sampling import flow_match as fm
from physicedit_torch.sampling.denoise import denoise

IMAGE_PAD_ID = 151655
VISION_START_ID = 151652


class PhysicEditPipeline:
    def __init__(self, dit: DiT, vae: m_vae.VAE, text: QwenVLText,
                 vision: QwenVLVision, adapter=None, tokenizer=None, dinov2=None,
                 dtype=torch.bfloat16, device="cuda", boi_token_id=None,
                 eoi_token_id=None, image_pad_id: int = IMAGE_PAD_ID,
                 vision_start_id: int = VISION_START_ID,
                 edit_drop_idx: int = P.EDIT_DROP_IDX,
                 rope_axes: tuple = m_rope.AXES_DIM, txt_len_bucket: int = 64,
                 kv_int8: bool = False):
        self.dit, self.vae, self.text, self.vision = dit, vae, text, vision
        self.adapter = adapter
        self.dinov2 = dinov2            # the training prior's DINOv2 (train/)
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = torch.device(device)
        self.boi_token_id, self.eoi_token_id = boi_token_id, eoi_token_id
        self.image_pad_id, self.vision_start_id = image_pad_id, vision_start_id
        self.edit_drop_idx = edit_drop_idx
        self.rope_axes = rope_axes
        self.txt_len_bucket = txt_len_bucket
        self.kv_int8 = kv_int8          # int8 reasoner KV cache (the W4 lane's)
        self.t_min, self.t_max = fm.adapter_t_range()
        # load-time decision (models/dit.attn_clamp_needed)
        self.attn_clamp = attn_clamp_needed(dit)
        self.timings: dict = {}

    def to(self, device) -> "PhysicEditPipeline":
        """Move every model to ``device``.  Nothing is cast: the models are
        built in the working dtype, and the quantized lane's int8 weights
        and fp32 scales keep theirs."""
        self.device = torch.device(device)
        for m in (self.dit, self.vae, self.text, self.vision, self.adapter, self.dinov2):
            if m is not None:
                m.to(device=self.device)
        return self

    @torch.no_grad()
    def quantize_(self, mode: str = "int4") -> "PhysicEditPipeline":
        """The body of the JAX package's ``from_pretrained(quantize=...)``
        branch, applied in place, one layer at a time.

        ``"int4"`` / ``"w4"``: the DiT blocks packed int4 (the outer leaves
        ``DIT_OUTER_KEYS`` stay in the working dtype); the VL text model
        packed int4 with fused qkv / gate_up projections and an int8 token
        table, and the reasoner's KV cache int8; the ViT packed int4.  The
        adapter and the VAE stay as they are.  ``"int8"`` (W8A8) is not
        ported."""
        if mode == "int8":
            raise NotImplementedError("quantize='int8' (W8A8, ops/quant.py) is not ported")
        if mode not in ("int4", "w4"):
            raise ValueError(f"unknown quantize mode: {mode!r}")
        quantize_module_int4(self.dit, skip_top=DIT_OUTER_KEYS)
        quantize_embedding_int8(fuse_decode_projections(quantize_module_int4(self.text)))
        self.kv_int8 = True
        quantize_module_int4(self.vision)
        return self

    @contextlib.contextmanager
    def _timed(self, name: str):
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def _tensor(self, arr, dtype=None):
        return torch.as_tensor(np.asarray(arr), device=self.device).to(dtype or self.dtype)

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def generate_noise(self, shape, seed: int | None) -> torch.Tensor:
        """Seeded latent noise [1, h, w, 16]: the torch CPU generator in the
        pipeline dtype (the reference's bitstream), moved to the device."""
        gen = None if seed is None else torch.Generator("cpu").manual_seed(seed)
        h, w, c = shape[1], shape[2], shape[3]
        noise = torch.randn((shape[0], c, h, w), generator=gen, dtype=self.dtype)
        return noise.permute(0, 2, 3, 1).contiguous().to(self.device)

    def encode_image(self, image) -> torch.Tensor:
        """PIL -> VAE latents [1, H/8, W/8, 16]."""
        w, h = image.size
        if h % 8 or w % 8:
            raise ValueError(f"image size {w}x{h} must be /8 (use the auto-resize path)")
        arr = np.asarray(image.convert("RGB"), np.float32) / 127.5 - 1.0
        with self._timed("vae_encode"):
            return m_vae.encode(self.vae, self._tensor(arr[None]))

    def decode_image(self, latents: torch.Tensor):
        from PIL import Image

        with self._timed("vae_decode"):
            img = m_vae.decode(self.vae, latents.to(self.dtype))
            arr = img[0].float().cpu().numpy()
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                "VAE decode produced non-finite pixels - upstream latents are "
                "NaN/Inf (check the schedule and model outputs)")
        return Image.fromarray(np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8))

    def edit_image_auto_resize(self, image):
        """~1024-square, /32 resize."""
        w, h = vl_host.calculate_dimensions(1024 * 1024, image.size[0] / image.size[1])
        return image.resize((w, h))

    def _vision_features(self, images: list):
        """Vision-tower features for PIL images (pre-resized to the VL input
        size), one image per call; returns (features per image, grids)."""
        feats, grids = [], []
        with self._timed("vision"):
            for im in images:
                patches, grid = vl_host.images_to_patches([im])
                f = self.vision(self._tensor(patches), grid)
                feats.append(f.float().cpu().numpy())
                grids.append(grid[0])
        return feats, grids

    def _vl_host_inputs(self, text: str, images: list, feats=None, grids=None):
        """Host side of one VL row: (ids [S] int32, embeds [S, D] fp32,
        rope positions [3, S])."""
        ids = self.tokenizer(text).input_ids
        feats_cat = None
        if images:
            if feats is None:
                feats, grids = self._vision_features(
                    [vl_host.resize_vl_image(im) for im in images])
            ids = vl_host.expand_image_pads(ids, grids, self.image_pad_id)
            feats_cat = np.concatenate(feats, axis=0)
        else:
            grids = []
        ids = np.asarray(ids, np.int32)
        embeds = self.text.embed_tokens(
            torch.from_numpy(ids).long().to(self.device)).float().cpu().numpy()
        if feats_cat is not None:
            embeds = vl_host.scatter_vision_features(embeds, ids, feats_cat,
                                                     self.image_pad_id)
        pos = vl_host.get_rope_index(ids, grids, self.image_pad_id, self.vision_start_id)
        return ids, embeds, pos

    def _vl_hidden_batch(self, rows: list):
        """Batched VL encode of rows [(text, images, feats, grids), ...]:
        right-padded to a shared /128 length, key-masked, in chunks of 4.
        Returns [(ids, hidden[:len]), ...]."""
        items = [self._vl_host_inputs(t, ims, f, g) for t, ims, f, g in rows]
        b = len(items)
        s_pad = (max(len(it[0]) for it in items) + 127) // 128 * 128
        emb_b = np.zeros((b, s_pad, items[0][1].shape[1]), np.float32)
        pos_b = np.zeros((3, b, s_pad), np.int64)
        mask = np.zeros((b, s_pad), bool)
        for i, (ids, embeds, pos) in enumerate(items):
            s = len(ids)
            emb_b[i, :s] = embeds
            pos_b[:, i, :s] = pos
            pos_b[:, i, s:] = pos.max() + 1
            mask[i, :s] = True
        chunk = 4
        hidden = np.concatenate([
            self.text.text_forward(self._tensor(emb_b[c0:c0 + chunk]),
                                   self._tensor(pos_b[:, c0:c0 + chunk], torch.long),
                                   self._tensor(mask[c0:c0 + chunk], torch.bool))
            .float().cpu().numpy() for c0 in range(0, b, chunk)])
        return [(it[0], hidden[i, :len(it[0])]) for i, it in enumerate(items)]

    def _edit_hidden_post(self, ids, hidden):
        """Drop the template prefix and locate the special-token span."""
        hidden = hidden[self.edit_drop_idx:]
        ids_d = ids[self.edit_drop_idx:]
        special = None
        if self.boi_token_id is not None:
            boi = np.where(ids_d == self.boi_token_id)[0]
            eoi = np.where(ids_d == self.eoi_token_id)[0]
            if boi.size and eoi.size:
                special = np.arange(boi[0] + 1, eoi[0])
        return hidden, special

    def encode_prompt_edit_batch(self, prompts: list, edit_images: list,
                                 feats_list=None, grids=None):
        """Edit-path prompt encodes in one batched VL forward; returns
        [(prompt_emb [S, D], special positions [64] or None), ...]."""
        rows = []
        for i, (prompt, im) in enumerate(zip(prompts, edit_images)):
            f = None if feats_list is None else [feats_list[i]]
            g = None if feats_list is None else [grids[i]]
            rows.append((P.edit_prompt_text(prompt), [im], f, g))
        with self._timed("prompt_encode"):
            out = self._vl_hidden_batch(rows)
        return [self._edit_hidden_post(ids, hidden) for ids, hidden in out]

    def encode_prompt_edit(self, prompt: str, edit_image):
        """One edit-path prompt encode: (prompt_emb [S, D], special
        positions [64] or None)."""
        return self.encode_prompt_edit_batch([prompt], [edit_image])[0]

    def _reasoner_inputs(self, prompt: str, edit_image, feats=None, grid=None):
        text = P.reasoner_chat_text(P.REASONER_SYSTEM_PROMPT, [
            ("text", "Edit Instruction:"), ("text", prompt),
            ("text", "Edit Image:"), ("image",)])
        ids, embeds, pos = self._vl_host_inputs(
            text, [edit_image], None if feats is None else [feats],
            None if feats is None else [grid])
        return embeds, pos, len(ids)

    def reason_physical_batch(self, prompts: list, edit_images: list,
                              max_new_tokens: int = 1000, vl_feats=None,
                              vl_grids=None) -> list:
        """Physical reasoning for N edits: prompts left-padded to a shared
        /128 length, prefilled one row at a time, then one greedy decode over
        the batch; rows stop independently at EOS."""
        items = [self._reasoner_inputs(
            p, im, None if vl_feats is None else vl_feats[i],
            None if vl_grids is None else vl_grids[i])
            for i, (p, im) in enumerate(zip(prompts, edit_images))]
        b = len(items)
        s_pad = (max(s for _, _, s in items) + 127) // 128 * 128
        max_total = s_pad + max_new_tokens
        embeds_p = np.zeros((b, s_pad, items[0][0].shape[1]), np.float32)
        pos_p = np.zeros((3, b, s_pad), np.int64)
        attn_mask = np.zeros((b, s_pad), bool)
        start_rope = np.zeros((b,), np.int64)
        for i, (emb, pos, s) in enumerate(items):
            embeds_p[i, s_pad - s:] = emb
            pos_p[:, i, s_pad - s:] = pos
            attn_mask[i, s_pad - s:] = True
            start_rope[i] = int(pos.max()) + 1
        logits, parts = [], []
        with self._timed("reasoner_prefill"):
            for r in range(b):
                lg, cache, _ = self.text.prefill(
                    self._tensor(embeds_p[r:r + 1]),
                    self._tensor(pos_p[:, r:r + 1], torch.long),
                    self._tensor(attn_mask[r:r + 1], torch.bool), max_total,
                    kv_int8=self.kv_int8)
                logits.append(lg)
                parts.append(cache)
        caches = tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(len(parts[0])))
        first = torch.cat(logits).argmax(-1)
        key_mask = self._tensor(np.concatenate(
            [attn_mask, np.zeros((b, max_total - s_pad), bool)], axis=1), torch.bool)
        with self._timed("reasoner_decode"):
            toks, steps = self.text.greedy_decode(
                caches, first, s_pad, self._tensor(start_rope, torch.long),
                max_new_tokens, key_mask=key_mask)
            toks = toks.cpu().numpy()
        self.timings["decode_tokens"] = self.timings.get("decode_tokens", 0) + steps
        eos = self.text.cfg.eos_token_id
        outs = []
        for row in toks.tolist():
            if eos in row:
                row = row[:row.index(eos)]
            decoded = self.tokenizer.decode(row, skip_special_tokens=True)
            outs.append(P.reasoner_text_from_response(decoded))
        return outs

    # ------------------------------------------------------------------
    # Full edit
    # ------------------------------------------------------------------

    def __call__(self, prompt: str, negative_prompt: str = "", edit_image=None,
                 cfg_scale: float = 4.0, cfg_truncate_step: int | None = None,
                 inpaint_mask=None, inpaint_blur_size: int | None = None,
                 inpaint_blur_sigma: float | None = None,
                 height: int = 1328, width: int = 1328, seed: int | None = None,
                 num_inference_steps: int = 30,
                 exponential_shift_mu: float | None = None,
                 denoising_strength: float = 1.0,
                 edit_image_auto_resize: bool = True,
                 edit_rope_interpolation: bool = False,
                 have_text_reasoning: bool = True, input_image=None,
                 context_image=None, eligen_entity_prompts: list | None = None,
                 eligen_entity_masks: list | None = None,
                 eligen_enable_on_negative: bool = False,
                 blockwise_controlnet_image=None,
                 blockwise_controlnet_scale: float = 1.0,
                 blockwise_controlnet_start: float = 1.0,
                 blockwise_controlnet_end: float = 0.0,
                 tiled: bool = False, tile_size: int = 128, tile_stride: int = 64,
                 rand_device: str = "cpu", enable_fp8_attention: bool = False,
                 progress_bar_cmd=None, is_train: bool = False):
        """One single-image physics-aware edit; returns a PIL image.

        The signature is the JAX package's.  tiled / tile_size / tile_stride
        / enable_fp8_attention / progress_bar_cmd are accepted and ignored
        as there; the options of other paths raise NotImplementedError.
        """
        del tiled, tile_size, tile_stride, enable_fp8_attention, progress_bar_cmd
        del eligen_enable_on_negative, blockwise_controlnet_scale, \
            blockwise_controlnet_start, blockwise_controlnet_end, \
            inpaint_blur_size, inpaint_blur_sigma
        if rand_device != "cpu":
            raise ValueError("rand_device='cpu' is the only supported mode (the "
                             "reference default)")
        unported = {"is_train": is_train or None, "input_image": input_image,
                    "inpaint_mask": inpaint_mask, "context_image": context_image,
                    "eligen_entity_prompts": eligen_entity_prompts or None,
                    "eligen_entity_masks": eligen_entity_masks or None,
                    "blockwise_controlnet_image": blockwise_controlnet_image}
        for name, val in unported.items():
            if val is not None:
                raise NotImplementedError(f"{name}: only the single-image edit "
                                          "path is ported")
        if edit_image is None or isinstance(edit_image, (list, tuple)):
            raise NotImplementedError("edit_image: only the single-image edit "
                                      "path is ported (no text-to-image, no "
                                      "multi-image edits)")
        self.timings = {}
        height, width = (height + 15) // 16 * 16, (width + 15) // 16 * 16
        lat_h, lat_w = height // 8, width // 8
        sched = fm.build_schedule(
            num_inference_steps, fm.QWEN_IMAGE_CONFIG,
            denoising_strength=denoising_strength,
            dynamic_shift_len=(height // 16) * (width // 16),
            exponential_shift_mu=exponential_shift_mu)
        latents = self.generate_noise((1, lat_h, lat_w, 16), seed)

        resized = self.edit_image_auto_resize(edit_image) if edit_image_auto_resize \
            else edit_image
        lat = self.encode_image(resized)
        img_shapes = [(1, lat_h // 2, lat_w // 2), (1, lat.shape[1] // 2, lat.shape[2] // 2)]
        extra_tokens = patchify(lat)

        # vision features once, shared by the reasoner and both CFG rows
        vl_feats, vl_grids = self._vision_features([vl_host.resize_vl_image(edit_image)])
        physical_txt = ""
        if have_text_reasoning:
            physical_txt = self.reason_physical_batch(
                [prompt], [edit_image], vl_feats=vl_feats, vl_grids=vl_grids)[0]

        (emb_p, special_p), (emb_n, special_n) = self.encode_prompt_edit_batch(
            [prompt + physical_txt, negative_prompt], [edit_image] * 2,
            feats_list=vl_feats * 2, grids=vl_grids * 2)

        use_cfg = cfg_scale != 1.0
        embs = [emb_p, emb_n] if use_cfg else [emb_p]
        specials = [special_p, special_n] if use_cfg else [special_p]
        prompt_emb, txt_mask = vl_host.bucket_pad_text(embs, self.txt_len_bucket)
        s_t = txt_mask.shape[1]
        special_idx = None
        if self.adapter is not None and all(s is not None for s in specials):
            special_idx = self._tensor(np.stack(specials), torch.long)
        ropes = m_rope.build_rope_tables(img_shapes, s_t,
                                         edit_rope_interpolation=edit_rope_interpolation,
                                         axes_dim=self.rope_axes)
        self.timings["joint_tokens"] = s_t + sum(f * h * w for f, h, w in img_shapes)
        self.timings["steps"] = num_inference_steps

        with self._timed("denoise"):
            latents = denoise(
                self.dit, latents, extra_tokens, self._tensor(prompt_emb),
                self._tensor(txt_mask, torch.bool),
                *(self._tensor(r, torch.float32) for r in ropes),
                self._tensor(sched.sigmas, torch.float32),
                self._tensor(sched.sigmas_next, torch.float32),
                self._tensor(sched.timesteps, torch.float32), float(cfg_scale),
                latent_hw=(lat_h, lat_w), adapter=self.adapter,
                special_idx=special_idx, t_min=self.t_min, t_max=self.t_max,
                attn_clamp=self.attn_clamp, cfg_truncate_after=cfg_truncate_step)
        return self.decode_image(latents)
