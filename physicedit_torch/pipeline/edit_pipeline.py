"""The PhysicEdit edit pipeline on PyTorch
(``physicedit_tpu/pipeline/edit_pipeline.py``): image + instruction ->
edited image.

Stages of the single-image edit: VAE-encode the edit image; run the vision
tower once and share its features; the Qwen2.5-VL reasoner writes the
physical-transition text (prefill + greedy decode); encode the CFG positive
and negative prompts with the 64 special tokens; denoise over the DiT with
the per-step special-token rewrite; VAE-decode.  ``__call__`` takes every
option of the JAX package's: text-to-image, multi-image edits, a context
image, ``input_image`` with an inpaint mask, EliGen entity control (prompt
segments and an attention bias built on the host, consumed by kernel K7)
and the blockwise ControlNet.  ``edit_batch`` and ``edit_batch_mixed`` serve
N edits with one conditioning batch (vision tower once per item, one
reasoner decode, one prompt encode).  Host-side string and geometry work
lives in this package's copies of the JAX package's ``pipeline/prompt.py``,
``pipeline/vl_host.py``, ``pipeline/eligen.py`` and
``sampling/flow_match.py``.

Each call leaves its stage times, on the host clock around work that ends in
a device synchronise, in ``self.timings`` (milliseconds), beside the token
counts that set the stages' shapes.

:meth:`PhysicEditPipeline.quantize_` turns a loaded pipeline into the JAX
package's ``quantize="int4"`` (W4A8) or ``quantize="int8"`` (W8A8) serving
lane, in place.  :meth:`PhysicEditPipeline.shard` spreads it over a
mesh of GPUs (``parallel/sharding.py``, one process per GPU): the DiT and
the VL text model tensor-parallel over ``model``, the serving batch of
``edit_batch`` / ``edit_batch_mixed`` over ``data``.
:meth:`PhysicEditPipeline.from_pretrained` builds a pipeline from checkpoint
files in the reference's torch layout (``io/convert.py``), identified by the
hash of their keys, with an optional finetuned PhysicEdit export or LoRA file
merged into the DiT; ``load_lora`` / ``clear_lora`` merge or hot-load a LoRA
afterwards.  ``attn_impl`` names the DiT's attention: ``"kernels"`` (K1 /
K7, the JAX package's ``"pallas"``), ``"dense"`` (its ``"xla"``) or
``"ring"`` (sequence-parallel, ``models.dit.set_ring_context``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings

import numpy as np
import torch

from physicedit_torch.kernels.flash_attention import LOG2E
from physicedit_torch.kernels.quant_matmul import (DIT_OUTER_KEYS, W4Linear,
                                                   quantize_module_int4)
from physicedit_torch import lora as tlora
from physicedit_torch.io import convert as C
from physicedit_torch.io.safetensors_io import (EXTENSION_LOADERS, detect_model_name,
                                                load_state_dict)
from physicedit_torch.models import vae as m_vae
from physicedit_torch.models.controlnet import (Control, controlnet_step_scales,
                                                process_conditioning)
from physicedit_torch.models.dit import DiT, attn_clamp_needed
from physicedit_torch.models.qwen_vl import (Int8Embedding, QwenVLText, fuse_decode_projections,
                                             quantize_embedding_int8)
from physicedit_torch.models.qwen_vl_vision import QwenVLVision
from physicedit_torch.ops import rope as m_rope
from physicedit_torch.ops.quant import Int8Linear, quantize_module_int8
from physicedit_torch.ops.patchify import patchify
from physicedit_torch.parallel import comm
from physicedit_torch.parallel import sharding as shd
from physicedit_torch.pipeline import eligen as EL
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
                 edit_drop_idx: int = P.EDIT_DROP_IDX, t2i_drop_idx: int = P.T2I_DROP_IDX,
                 rope_axes: tuple = m_rope.AXES_DIM, txt_len_bucket: int = 64,
                 kv_int8: bool = False, controlnet=None, attn_impl: str = "kernels",
                 adapters: dict | None = None):
        self.dit, self.vae, self.text, self.vision = dit, vae, text, vision
        # every adapter group of a finetuned checkpoint; the DiT uses the dual one
        self.adapters = dict(adapters or {})
        self.adapter = adapter if adapter is not None else self.adapters.get(
            "visual_thinking_adapter")
        self.attn_impl = attn_impl      # "kernels", "dense" or "ring" (models/dit.py)
        self.mesh = None                # a DeviceMesh after shard()
        self.dit_lora = None            # hot-loaded LoRA factors (load_lora)
        self.dinov2 = dinov2            # the training prior's DINOv2 (train/)
        self.controlnet = controlnet    # models/controlnet.BlockwiseControlNet or None
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = torch.device(device)
        self.boi_token_id, self.eoi_token_id = boi_token_id, eoi_token_id
        self.image_pad_id, self.vision_start_id = image_pad_id, vision_start_id
        self.edit_drop_idx, self.t2i_drop_idx = edit_drop_idx, t2i_drop_idx
        self.rope_axes = rope_axes
        self.txt_len_bucket = txt_len_bucket
        self.kv_int8 = kv_int8          # int8 reasoner KV cache (the W4 lane's)
        self.t_min, self.t_max = fm.adapter_t_range()
        # load-time decision (models/dit.attn_clamp_needed)
        self.attn_clamp = True if dit is None else attn_clamp_needed(dit)
        self.timings: dict = {}

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @classmethod
    @torch.no_grad()
    def from_pretrained(cls, model_paths: list | None = None,
                        tokenizer_path: str | None = None, dtype=torch.bfloat16,
                        attn_impl: str | None = None, lora_path: str | None = None,
                        finetuned_path: str | None = None, quantize: str | None = None,
                        model_id: str | None = None, local_model_path: str = "./models",
                        skip_download: bool = False,
                        device="cuda") -> "PhysicEditPipeline":
        """Build the pipeline from checkpoint files (the JAX package's
        ``from_pretrained``).

        ``model_paths``: safetensors files, lists of shards or folders, or
        ``io.model_config.ModelConfig`` rows, each identified by the hash of
        its keys (``io/safetensors_io.detect_model_name``) and loaded
        straight into the port's modules in ``dtype`` on ``device``.
        ``model_id`` resolves a Qwen-Image preset (``io/model_config.py``)
        under ``local_model_path``; ``skip_download`` keeps the hub gate
        closed.  ``finetuned_path``: a PhysicEdit training export, its DiT
        LoRA merged into the DiT weights (fp32 merge, then the cast) and its
        ``pipe.*`` adapter groups loaded in fp32; else ``lora_path``: a LoRA
        file merged alike.  ``quantize`` ("int4" or "int8") applies
        :meth:`quantize_`;
        ``attn_impl`` defaults to ``ops.attention.default_impl()``.  The
        text model's and the ViT's configs come from the ``config.json``
        beside the text-encoder files (else Qwen2.5-VL-7B's at the
        checkpoint's depth), the DiT's and the VAE's from the shapes.
        """
        from physicedit_torch.io.model_config import ModelConfig, qwen_image_preset
        from physicedit_torch.ops.attention import default_impl

        if model_id is not None:
            preset = qwen_image_preset(model_id, local_model_path, skip_download)
            model_paths = list(model_paths or []) + preset["model_configs"]
            if tokenizer_path is None:
                tokenizer_path = preset["tokenizer_config"]
        if model_paths is None:
            raise ValueError("pass model_paths and/or a preset model_id")
        model_paths = [p.download_if_necessary() if isinstance(p, ModelConfig) else p
                       for p in model_paths]
        if isinstance(tokenizer_path, ModelConfig):
            tokenizer_path = tokenizer_path.download_if_necessary()

        parts, part_paths = {}, {}
        for path in model_paths:
            sd = load_state_dict(path)
            name = detect_model_name(sd)
            if name is None:
                raise ValueError(f"unrecognised checkpoint: {path}")
            if name in EXTENSION_LOADERS:
                raise ValueError(f"{path} is a '{name}' checkpoint: not a pipeline part; load "
                                 f"it with {EXTENSION_LOADERS[name]}")
            parts[name] = sd
            part_paths[name] = path[0] if isinstance(path, (list, tuple)) else path

        adapters = {}
        dit_sd = parts.get("qwen_image_dit")
        if finetuned_path is not None:
            lora_sd, pipe_sd = tlora.split_finetuned_checkpoint(load_state_dict(finetuned_path))
            lora_sd = {k.replace("pipe.dit.", ""): v for k, v in lora_sd.items()}
            if dit_sd is not None and lora_sd:
                dit_sd = tlora.merge_lora_into_state_dict(dit_sd, lora_sd, dtype=dtype)
            adapters = C.physic_adapters_from_state_dict(pipe_sd, torch.float32, device)
        elif lora_path is not None and dit_sd is not None:
            dit_sd = tlora.merge_lora_into_state_dict(dit_sd, load_state_dict(lora_path),
                                                      dtype=dtype)

        kw = dict(adapters=adapters, dtype=dtype, device=device,
                  attn_impl=attn_impl or default_impl())
        kw["dit"] = None if dit_sd is None else C.dit_from_state_dict(dit_sd, dtype, device)
        del dit_sd
        vae_sd = parts.pop("qwen_image_vae", None)
        kw["vae"] = None if vae_sd is None else C.vae_from_state_dict(vae_sd, dtype, device)
        kw["text"] = kw["vision"] = None
        if "qwen_image_text_encoder" in parts:
            sd = C.remap_text_encoder_keys(parts.pop("qwen_image_text_encoder"))
            text_cfg = vision_cfg = None
            where = part_paths["qwen_image_text_encoder"]
            cfg_json = os.path.join(where if os.path.isdir(where) else os.path.dirname(where),
                                    "config.json")
            if os.path.exists(cfg_json):
                with open(cfg_json) as f:
                    hf = json.load(f)
                text_cfg, vision_cfg = C.text_config_from_hf(hf), C.vision_config_from_hf(hf)
                kw["image_pad_id"] = text_cfg.image_token_id
                kw["vision_start_id"] = text_cfg.vision_start_token_id
            kw["text"] = C.qwen_vl_text_from_state_dict(sd, text_cfg, dtype, device)
            kw["vision"] = C.qwen_vl_vision_from_state_dict(sd, vision_cfg, dtype, device)
            del sd
        parts.clear()
        pipe = cls(**kw)
        if quantize is not None:
            pipe.quantize_(quantize)
        if tokenizer_path is not None:
            pipe.load_tokenizer(tokenizer_path)
        return pipe

    def load_tokenizer(self, path: str) -> None:
        """The Qwen2 tokenizer of ``path`` with PhysicEdit's special tokens
        (host only; ``transformers`` is imported here, not at import)."""
        from transformers import Qwen2Tokenizer

        tok = Qwen2Tokenizer.from_pretrained(path)
        tok.add_special_tokens({"additional_special_tokens": P.SPECIAL_TOKENS})
        self.tokenizer = tok
        self.boi_token_id = tok.convert_tokens_to_ids("<begin_of_img>")
        self.eoi_token_id = tok.convert_tokens_to_ids("<end_of_img>")

    @torch.no_grad()
    def load_lora(self, lora_path: str, alpha: float = 1.0, hotload: bool = False) -> None:
        """A DiT LoRA file (peft keys, with or without ``pipe.dit.``):
        merged into the DiT's float weights (``W += alpha * B @ A`` in fp32),
        or with ``hotload`` kept as live fp32 factors that every denoise step
        applies (the training forward's LoRA path) until :meth:`clear_lora`."""
        sd = {k.replace("pipe.dit.", ""): v for k, v in load_state_dict(lora_path).items()}
        lora = tlora.import_dit_lora(sd, self.dit.cfg, torch.float32, self.device)
        if hotload:
            if alpha != 1.0:
                for leaf in lora.children():
                    leaf.A.mul_(alpha)
            self.dit_lora = lora
        else:
            tlora.merge_dit_lora_(self.dit, lora, alpha)

    def clear_lora(self) -> None:
        """Drop hot-loaded LoRA factors."""
        self.dit_lora = None

    def to(self, device) -> "PhysicEditPipeline":
        """Move every model to ``device``.  Nothing is cast: the models are
        built in the working dtype, and the quantized lane's int8 weights
        and fp32 scales keep theirs."""
        self.device = torch.device(device)
        for m in (self.dit, self.vae, self.text, self.vision, self.adapter, self.dinov2,
                  self.controlnet):
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
        table, and the reasoner's KV cache int8; the ViT packed int4.
        ``"int8"`` (W8A8, ``ops/quant.py``): every large linear of the DiT and
        of the VL text model (``lm_head`` included) int8 per output channel,
        the activations int8 per row at run time; the ViT, the KV cache, the
        token table, the adapter and the VAE stay as they are (a model the
        pipeline was loaded without is skipped, as in the JAX package)."""
        if self.mesh is not None:
            raise ValueError("quantize_ after shard(): quantized residency and mesh sharding "
                             "are alternative memory strategies - quantize an unsharded "
                             "pipeline")
        if mode == "int8":
            for model in (self.dit, self.text):
                if model is not None:
                    quantize_module_int8(model)
            return self
        if mode not in ("int4", "w4"):
            raise ValueError(f"unknown quantize mode: {mode!r}")
        quantize_module_int4(self.dit, skip_top=DIT_OUTER_KEYS)
        quantize_embedding_int8(fuse_decode_projections(quantize_module_int4(self.text)))
        self.kv_int8 = True
        quantize_module_int4(self.vision)
        return self

    @torch.no_grad()
    def shard(self, mesh) -> "PhysicEditPipeline":
        """Spread the pipeline over a mesh (the JAX package's ``shard``): the
        DiT and the VL text model tensor-parallel over ``model``
        (``parallel/sharding.py``: each process keeps its slice of the split
        weights), everything else replicated, as is a hot-loaded LoRA and the
        adapters (every process already holds its own copy).  ``edit_batch``
        and ``edit_batch_mixed`` then split their items over ``data``.
        Quantized weights raise: the two are alternative memory strategies."""
        def quantized(model):
            return model is not None and any(
                isinstance(m, (W4Linear, Int8Linear, Int8Embedding)) for m in model.modules())

        if quantized(self.dit) or quantized(self.text):
            raise ValueError(
                "shard() needs unquantized bf16 weights: quantized residency "
                "(quantize='int8'/'int4') and mesh sharding are alternative memory "
                "strategies - reload with quantize=None to tensor-parallel over a mesh")
        shd.shard_params(self.dit, shd.dit_param_specs(self.dit), mesh)
        if self.text is not None:
            shd.shard_params(self.text, shd.qwen_vl_text_param_specs(self.text), mesh)
        self.mesh = mesh
        return self

    def _data_split(self, n: int, warn: bool):
        """(this process's items, the data group) when the mesh's ``data``
        axis divides the n items; None when there is no such axis, or, with
        a warning when ``warn``, when it does not divide n (every process
        then runs every item, as the JAX package runs without its DP
        placement)."""
        mesh = self.mesh
        if mesh is None:
            return None
        n_data = mesh.size(mesh.mesh_dim_names.index(shd.DATA_AXIS))
        if n_data == 1:
            return None
        if n % n_data:
            if warn:
                warnings.warn(f"{n} items do not divide the data axis ({n_data}); running "
                              f"WITHOUT data-parallel placement - pad the batch to a multiple "
                              f"of {n_data}")
            return None
        per, c = n // n_data, mesh.get_local_rank(shd.DATA_AXIS)
        return list(range(c * per, (c + 1) * per)), mesh.get_group(shd.DATA_AXIS)

    def _gather_images(self, images: list, group) -> list:
        """The data group's images (one shape) in rank order, on every rank."""
        from PIL import Image

        arr = torch.as_tensor(np.stack([np.asarray(im) for im in images]), device=self.device)
        return [Image.fromarray(a) for a in comm.all_gather_cat(arr, 0, group).cpu().numpy()]

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

    def decode_images(self, latents: torch.Tensor) -> list:
        """Latents [N, h, w, 16] -> N PIL images, in one VAE decode."""
        from PIL import Image

        with self._timed("vae_decode"):
            arr = m_vae.decode(self.vae, latents.to(self.dtype)).float().cpu().numpy()
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                "VAE decode produced non-finite pixels - upstream latents are "
                "NaN/Inf (check the schedule and model outputs)")
        arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
        return [Image.fromarray(a) for a in arr]

    def decode_image(self, latents: torch.Tensor):
        return self.decode_images(latents[:1])[0]

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

    def encode_prompt_batch(self, prompts: list) -> list:
        """Text-to-image prompt encodes (no image, ``t2i_drop_idx``) in one
        batched VL forward; EliGen encodes its entity prompts so.  Returns
        [prompt_emb [S_i, D], ...]."""
        rows = [(P.T2I_TEMPLATE.format(p), [], None, None) for p in prompts]
        with self._timed("prompt_encode"):
            out = self._vl_hidden_batch(rows)
        return [hidden[self.t2i_drop_idx:] for _, hidden in out]

    def encode_prompt(self, prompt: str):
        """One text-to-image prompt encode (no image, ``t2i_drop_idx``):
        (prompt_emb [S, D], None), as the JAX package's ``encode_prompt``."""
        return self.encode_prompt_batch([prompt])[0], None

    def encode_prompt_edit_multi(self, prompt: str, edit_images: list, feats=None, grids=None):
        """Multi-image edit prompt ("Picture i:" per image, no special
        tokens): (prompt_emb [S, D], None).  ``feats`` / ``grids`` reuse the
        images' vision features."""
        rows = [(P.multi_edit_prompt_text(prompt, len(edit_images)), edit_images, feats, grids)]
        with self._timed("prompt_encode"):
            (_, hidden), = self._vl_hidden_batch(rows)
        return hidden[self.edit_drop_idx:], None

    def _reasoner_inputs(self, prompt: str, edit_image, feats=None, grid=None):
        text = P.reasoner_chat_text(P.REASONER_SYSTEM_PROMPT, [
            ("text", "Edit Instruction:"), ("text", prompt),
            ("text", "Edit Image:"), ("image",)])
        ids, embeds, pos = self._vl_host_inputs(
            text, [edit_image], None if feats is None else [feats],
            None if feats is None else [grid])
        return embeds, pos, len(ids)

    def reason_physical(self, prompt: str, edit_image, max_new_tokens: int = 1000) -> str:
        """The physical reasoner for one edit: one row of
        :meth:`reason_physical_batch`."""
        return self.reason_physical_batch([prompt], [edit_image], max_new_tokens)[0]

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
        """One edit (or, with no ``edit_image``, one text-to-image
        generation); returns a PIL image.

        The signature and the paths are the JAX package's: a list of edit
        images is a multi-image edit; ``context_image`` adds in-context
        tokens at the output size; ``input_image`` starts from its noised
        latents, and with ``inpaint_mask`` (optionally blurred) repaints only
        the mask; ``eligen_entity_prompts`` / ``eligen_entity_masks`` prepend
        entity prompt segments with a spatial attention bias (K7);
        ``blockwise_controlnet_image`` drives ``self.controlnet``.  tiled /
        tile_size / tile_stride / enable_fp8_attention / progress_bar_cmd are
        accepted and ignored as there; ``is_train`` and a ``rand_device``
        other than "cpu" raise, as there.
        """
        del tiled, tile_size, tile_stride, enable_fp8_attention, progress_bar_cmd
        if rand_device != "cpu":
            raise ValueError("rand_device='cpu' is the only supported mode (the "
                             "reference default)")
        if is_train:
            raise NotImplementedError("training preprocessing lives in "
                                      "train.Trainer.preprocess")
        self.timings = {}
        height, width = (height + 15) // 16 * 16, (width + 15) // 16 * 16
        lat_h, lat_w = height // 8, width // 8
        sched = fm.build_schedule(
            num_inference_steps, fm.QWEN_IMAGE_CONFIG,
            denoising_strength=denoising_strength,
            dynamic_shift_len=(height // 16) * (width // 16),
            exponential_shift_mu=exponential_shift_mu)
        latents = self.generate_noise((1, lat_h, lat_w, 16), seed)
        input_latents = inpaint_lat = None
        if input_image is not None:
            input_latents = self.encode_image(input_image.resize((width, height)))
            sigma0 = torch.tensor(sched.sigmas[0], dtype=torch.float32)
            latents = fm.add_noise(input_latents.float(), latents.float(), sigma0).to(self.dtype)
            if inpaint_mask is not None:
                # latent-resolution soft mask: the mean over RGB, optionally blurred
                m = inpaint_mask.convert("RGB").resize((lat_w, lat_h))
                arr = np.asarray(m, np.float32).mean(-1) / 255.0
                if inpaint_blur_size is not None and inpaint_blur_sigma is not None:
                    arr = _gaussian_blur(arr, inpaint_blur_size, inpaint_blur_sigma)
                inpaint_lat = self._tensor(arr[None, :, :, None], torch.float32)

        multi_edit = isinstance(edit_image, (list, tuple))
        edit_images = list(edit_image) if multi_edit else (
            [edit_image] if edit_image is not None else [])
        img_shapes = [(1, lat_h // 2, lat_w // 2)]
        token_parts = []
        if context_image is not None:         # in-context image at the output size
            lat = self.encode_image(context_image.resize((width, height)))
            img_shapes.append((1, lat.shape[1] // 2, lat.shape[2] // 2))
            token_parts.append(patchify(lat))
        for im in edit_images:
            lat = self.encode_image(self.edit_image_auto_resize(im) if edit_image_auto_resize
                                    else im)
            img_shapes.append((1, lat.shape[1] // 2, lat.shape[2] // 2))
            token_parts.append(patchify(lat))
        extra_tokens = torch.cat(token_parts, dim=1) if token_parts else None

        # vision features once per edit image, shared by the reasoner and the prompts
        vl_feats = vl_grids = None
        if edit_images:
            vl_feats, vl_grids = self._vision_features(
                [vl_host.resize_vl_image(im) for im in edit_images])
        physical_txt = ""
        if have_text_reasoning and edit_images:
            physical_txt = self.reason_physical_batch(
                [prompt], edit_images[:1], vl_feats=vl_feats[:1], vl_grids=vl_grids[:1])[0]

        if multi_edit:
            emb_p, special_p = self.encode_prompt_edit_multi(prompt + physical_txt, edit_images,
                                                             vl_feats, vl_grids)
            emb_n, special_n = self.encode_prompt_edit_multi(negative_prompt, edit_images,
                                                             vl_feats, vl_grids)
        elif edit_images:
            (emb_p, special_p), (emb_n, special_n) = self.encode_prompt_edit_batch(
                [prompt + physical_txt, negative_prompt], edit_images * 2,
                feats_list=vl_feats * 2, grids=vl_grids * 2)
        else:
            (emb_p, emb_n), special_p, special_n = self.encode_prompt_batch(
                [prompt + physical_txt, negative_prompt]), None, None

        use_cfg = cfg_scale != 1.0
        eligen = bool(eligen_entity_prompts and eligen_entity_masks)
        seq_lens_p = seq_lens_n = txt_tables = None
        if eligen:
            # entity prompt segments before the prompt, in one batched encode
            entity_embs = self.encode_prompt_batch(eligen_entity_prompts)
            ent_lens = [e.shape[0] for e in entity_embs]
            seq_lens_p = ent_lens + [emb_p.shape[0]]
            emb_p = np.concatenate(entity_embs + [emb_p], axis=0)
            if special_p is not None:
                special_p = special_p + sum(ent_lens)
            if use_cfg and eligen_enable_on_negative:
                seq_lens_n = [emb_n.shape[0]] * (len(ent_lens) + 1)
                emb_n = np.concatenate([emb_n] * (len(ent_lens) + 1), axis=0)
                if special_n is not None:
                    special_n = special_n + sum(seq_lens_n[:-1])
            # text rope per segment and per CFG row (the negative row plain
            # unless it has the entity segments too)
            mvi = m_rope.max_vid_index_of(img_shapes)
            txt_tables = [_segment_tables(seq_lens_p, mvi, self.rope_axes)]
            if use_cfg:
                txt_tables.append(_segment_tables(seq_lens_n or [emb_n.shape[0]], mvi,
                                                  self.rope_axes))

        embs = [emb_p, emb_n] if use_cfg else [emb_p]
        specials = [special_p, special_n] if use_cfg else [special_p]
        prompt_emb, txt_mask = vl_host.bucket_pad_text(embs, self.txt_len_bucket)
        b, s_t = txt_mask.shape

        attn_bias_log2 = None
        if eligen:
            # built on the host once per edit, re-seated into the bucketed
            # text layout, put in K7's exp2 units (the fp32 multiply of
            # bias_log2), copied to the card once
            with self._timed("eligen_bias"):
                masks = [EL.downsample_entity_mask(m, lat_h, lat_w) for m in eligen_entity_masks]
                base_tokens = (lat_h // 2) * (lat_w // 2)
                img_tok = base_tokens + (0 if extra_tokens is None else extra_tokens.shape[1])
                rows = np.zeros((b, s_t + img_tok, s_t + img_tok), np.float32)
                for row, lens in enumerate([seq_lens_p, seq_lens_n][:b]):
                    if lens is not None:
                        _place(rows[row], EL.build_entity_bias(masks, lens, img_tok, base_tokens),
                               sum(lens), s_t)
                rows *= np.float32(LOG2E)
                attn_bias_log2 = self._tensor(rows, torch.float32)
                del rows

        control = None
        if blockwise_controlnet_image is not None and self.controlnet is not None:
            cond_lat = self.encode_image(blockwise_controlnet_image.resize((width, height)))
            cond = process_conditioning(self.controlnet, patchify(cond_lat).to(self.dtype))
            control = Control(self.controlnet, cond.expand(b, -1, -1), self._tensor(
                controlnet_step_scales(num_inference_steps, blockwise_controlnet_start,
                                       blockwise_controlnet_end, blockwise_controlnet_scale),
                torch.float32))

        ropes = list(m_rope.build_rope_tables(img_shapes, s_t,
                                              edit_rope_interpolation=edit_rope_interpolation,
                                              axes_dim=self.rope_axes))
        if txt_tables is not None:
            # [B, 1, s_t, 64]: each CFG row its own text table, over the heads
            padded = [_pad_table(tc, ts, s_t) for tc, ts in txt_tables]
            ropes[2:] = [np.stack([p[i] for p in padded])[:, None] for i in (0, 1)]
        self.timings["joint_tokens"] = s_t + sum(f * h * w for f, h, w in img_shapes)
        self.timings["steps"] = num_inference_steps
        latents = self._run_denoise(
            latents, extra_tokens, prompt_emb, txt_mask, specials, ropes, sched, cfg_scale,
            (lat_h, lat_w), cfg_truncate_step, attn_bias_log2=attn_bias_log2,
            inpaint_mask=inpaint_lat, input_latents=input_latents, control=control)
        return self.decode_image(latents)

    def _run_denoise(self, latents, extra_tokens, prompt_emb, txt_mask, specials, ropes, sched,
                     cfg_scale, latent_hw, cfg_truncate_step, **options):
        """The denoise of ``__call__`` and the serving paths, timed:
        host-side prompts, masks, specials and tables to the device, the
        special-token rewrite when the adapter and every row's special
        positions are there."""
        special_idx = None
        if self.adapter is not None and all(s is not None for s in specials):
            special_idx = self._tensor(np.stack(specials), torch.long)
        with self._timed("denoise"):
            return denoise(
                self.dit, latents, extra_tokens, self._tensor(prompt_emb),
                self._tensor(txt_mask, torch.bool),
                *(self._tensor(r, torch.float32) for r in ropes),
                self._tensor(sched.sigmas, torch.float32),
                self._tensor(sched.sigmas_next, torch.float32),
                self._tensor(sched.timesteps, torch.float32), float(cfg_scale),
                latent_hw=latent_hw, adapter=self.adapter, special_idx=special_idx,
                t_min=self.t_min, t_max=self.t_max, attn_clamp=self.attn_clamp,
                cfg_truncate_after=cfg_truncate_step, lora=self.dit_lora,
                attn_impl=self.attn_impl, **options)

    # ------------------------------------------------------------------
    # Batched serving
    # ------------------------------------------------------------------

    def _serving_conditioning(self, prompts: list, edit_images: list, negative_prompt: str,
                              use_cfg: bool, have_text_reasoning: bool):
        """The conditioning of N edits, shared by ``edit_batch`` and
        ``edit_batch_mixed``; every stage runs at a shape that does not
        depend on the output size.  The vision tower runs once per item, the
        reasoner once over all items (one prefill per row, one decode), the
        2N prompt encodes (positives, then negatives) in one batched VL
        forward.  Returns (prompt_emb [2N or N, S_t, D], txt_mask, per-row
        special positions)."""
        n = len(prompts)
        feats, grids = self._vision_features([vl_host.resize_vl_image(im) for im in edit_images])
        physical = [""] * n
        if have_text_reasoning:
            physical = self.reason_physical_batch(prompts, edit_images, vl_feats=feats,
                                                  vl_grids=grids)
        all_prompts = [p + t for p, t in zip(prompts, physical)]
        all_images = list(edit_images)
        if use_cfg:
            all_prompts += [negative_prompt] * n
            all_images += list(edit_images)
            feats, grids = feats + feats, grids + grids
        enc = self.encode_prompt_edit_batch(all_prompts, all_images, feats_list=feats,
                                            grids=grids)
        prompt_emb, txt_mask = vl_host.bucket_pad_text([e for e, _ in enc], self.txt_len_bucket)
        return prompt_emb, txt_mask, [sp for _, sp in enc]

    def edit_batch(self, prompts: list, edit_images: list, negative_prompt: str = "",
                   cfg_scale: float = 4.0, cfg_truncate_step: int | None = None,
                   height: int = 1024, width: int = 1024, seeds: list | None = None,
                   num_inference_steps: int = 40, have_text_reasoning: bool = True,
                   edit_image_auto_resize: bool = False) -> list:
        """Edit N same-resolution images in one denoise: the CFG batch
        carries N positives and N negatives (2N DiT rows).  Item i uses
        ``seeds[i]`` (default i) for its noise.  Returns N PIL images.  On a
        mesh (:meth:`shard`) each rank of the ``data`` axis denoises its
        N / n_data items after the shared conditioning, and every rank
        returns all N images in order."""
        n = len(prompts)
        if n < 1 or len(edit_images) != n:
            raise ValueError(f"edit_batch: {n} prompts for {len(edit_images)} images")
        self.timings = {}
        height, width = (height + 15) // 16 * 16, (width + 15) // 16 * 16
        lat_h, lat_w = height // 8, width // 8
        seeds = list(range(n)) if seeds is None else list(seeds)
        sched = fm.build_schedule(num_inference_steps, fm.QWEN_IMAGE_CONFIG,
                                  dynamic_shift_len=(height // 16) * (width // 16))
        noise = torch.cat([self.generate_noise((1, lat_h, lat_w, 16), s) for s in seeds])
        lats = [self.encode_image(self.edit_image_auto_resize(im) if edit_image_auto_resize
                                  else im) for im in edit_images]
        shapes = {tuple(lat.shape[1:3]) for lat in lats}
        if len(shapes) != 1:
            raise ValueError(f"edit_batch requires one resolution bucket, got {shapes}")
        (eh, ew), = shapes
        use_cfg = cfg_scale != 1.0
        prompt_emb, txt_mask, specials = self._serving_conditioning(
            prompts, edit_images, negative_prompt, use_cfg, have_text_reasoning)
        ropes = m_rope.build_rope_tables([(1, lat_h // 2, lat_w // 2), (1, eh // 2, ew // 2)],
                                         txt_mask.shape[1], axes_dim=self.rope_axes)
        split = self._data_split(n, warn=True)
        if split is None:
            latents = self._run_denoise(noise, torch.cat([patchify(lat) for lat in lats]),
                                        prompt_emb, txt_mask, specials, ropes, sched, cfg_scale,
                                        (lat_h, lat_w), cfg_truncate_step)
            return self.decode_images(latents)
        # data parallel: this process denoises its items (the CFG rows of
        # each), and the images come back in order from the whole data axis
        idxs, group = split
        rows = idxs + [n + i for i in idxs] if use_cfg else idxs
        latents = self._run_denoise(noise[idxs], torch.cat([patchify(lats[i]) for i in idxs]),
                                    prompt_emb[rows], txt_mask[rows], [specials[i] for i in rows],
                                    ropes, sched, cfg_scale, (lat_h, lat_w), cfg_truncate_step)
        return self._gather_images(self.decode_images(latents), group)

    def edit_batch_mixed(self, prompts: list, edit_images: list, negative_prompt: str = "",
                         cfg_scale: float = 4.0, cfg_truncate_step: int | None = None,
                         heights: list | None = None, widths: list | None = None,
                         seeds: list | None = None, num_inference_steps: int = 40,
                         have_text_reasoning: bool = True,
                         edit_image_auto_resize: bool = False) -> list:
        """Edit N images of mixed resolutions with one conditioning batch:
        only the denoise depends on the output size, so the items are then
        grouped by (output latent, edit latent) shape and each group
        denoises at its own size.  ``heights[i]`` / ``widths[i]`` default to
        image i's size; item i uses ``seeds[i]`` (default i).  Returns N PIL
        images in input order.  On a mesh a shape group whose size divides
        the ``data`` axis is split over it, as in :meth:`edit_batch`."""
        n = len(prompts)
        if n < 1 or len(edit_images) != n:
            raise ValueError(f"edit_batch_mixed: {n} prompts for {len(edit_images)} images")
        self.timings = {}
        if edit_image_auto_resize:
            edit_images = [self.edit_image_auto_resize(im) for im in edit_images]
        heights = [im.size[1] for im in edit_images] if heights is None else list(heights)
        widths = [im.size[0] for im in edit_images] if widths is None else list(widths)
        if len(heights) != n or len(widths) != n:
            raise ValueError("edit_batch_mixed: one height and one width per item")
        heights = [(h + 15) // 16 * 16 for h in heights]
        widths = [(w + 15) // 16 * 16 for w in widths]
        seeds = list(range(n)) if seeds is None else list(seeds)
        use_cfg = cfg_scale != 1.0
        lats = [self.encode_image(im) for im in edit_images]
        prompt_emb, txt_mask, specials = self._serving_conditioning(
            prompts, edit_images, negative_prompt, use_cfg, have_text_reasoning)

        groups: dict = {}
        for i, lat in enumerate(lats):
            groups.setdefault((heights[i] // 8, widths[i] // 8, *lat.shape[1:3]), []).append(i)
        results: list = [None] * n
        for (lat_h, lat_w, eh, ew), idxs in groups.items():
            # data parallel per shape group, when its size divides the data axis
            split = self._data_split(len(idxs), warn=False)
            mine = idxs if split is None else [idxs[j] for j in split[0]]
            sched = fm.build_schedule(num_inference_steps, fm.QWEN_IMAGE_CONFIG,
                                      dynamic_shift_len=(lat_h // 2) * (lat_w // 2))
            noise = torch.cat([self.generate_noise((1, lat_h, lat_w, 16), seeds[i])
                               for i in mine])
            rows = mine + [n + i for i in mine] if use_cfg else mine
            ropes = m_rope.build_rope_tables([(1, lat_h // 2, lat_w // 2), (1, eh // 2, ew // 2)],
                                             txt_mask.shape[1], axes_dim=self.rope_axes)
            latents = self._run_denoise(
                noise, torch.cat([patchify(lats[i]) for i in mine]), prompt_emb[rows],
                txt_mask[rows], [specials[i] for i in rows], ropes, sched, cfg_scale,
                (lat_h, lat_w), cfg_truncate_step)
            images = self.decode_images(latents)
            if split is not None:
                images = self._gather_images(images, split[1])
            for img, i in zip(images, idxs):
                results[i] = img
        return results


def _segment_tables(seq_lens: list, max_vid_index: int, axes: tuple):
    """Text cos/sin tables [sum(seq_lens), 64] whose positions restart at
    ``max_vid_index`` in every prompt segment."""
    tables = [m_rope.text_rope_tables(n, max_vid_index, axes) for n in seq_lens]
    return (np.concatenate([c for c, _ in tables]), np.concatenate([s for _, s in tables]))


def _pad_table(tc, ts, s_t: int):
    """A text table padded (cos 1, sin 0: masked positions) or cut to s_t rows."""
    pad = max(0, s_t - tc.shape[0])
    tc = np.concatenate([tc, np.ones((pad, tc.shape[1]), np.float32)])
    ts = np.concatenate([ts, np.zeros((pad, ts.shape[1]), np.float32)])
    return tc[:s_t], ts[:s_t]


def _place(out: np.ndarray, bias: np.ndarray, txt_len: int, s_t: int) -> None:
    """Seat an unpadded [txt + img, txt + img] bias into ``out``, the joint
    layout whose text axis is padded to s_t (the padded keys are masked)."""
    out[:txt_len, :txt_len] = bias[:txt_len, :txt_len]
    out[:txt_len, s_t:] = bias[:txt_len, txt_len:]
    out[s_t:, :txt_len] = bias[txt_len:, :txt_len]
    out[s_t:, s_t:] = bias[txt_len:, txt_len:]


def _gaussian_blur(arr: np.ndarray, blur_size: int, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with kernel size 2 * blur_size + 1 and
    reflected edges (torchvision's GaussianBlur), in float64."""
    k = 2 * blur_size + 1
    x = np.arange(k) - blur_size
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    pad = blur_size
    padded = np.pad(arr, ((pad, pad), (0, 0)), mode="reflect")
    arr = np.stack([np.convolve(padded[:, j], g, mode="valid")
                    for j in range(arr.shape[1])], axis=1)
    padded = np.pad(arr, ((0, 0), (pad, pad)), mode="reflect")
    return np.stack([np.convolve(padded[i, :], g, mode="valid")
                     for i in range(arr.shape[0])], axis=0)
