"""Image quality / preference-score registry
(``physicedit_tpu/extensions/quality_metric.py``).

The reference registry maps metric names to CLIP-family preference models
(ImageReward, Aesthetic, PickScore, CLIP, HPSv2/v2.1, MPS) downloaded from
modelscope.  This keeps the same API, ``download_preference_model(name)`` /
``load_preference_model(name, device=, path=)`` / ``scorer.score(images,
prompt)``, with two lanes:

- **checkpoint-backed scorers**: "CLIP" / "Aesthetic" / "PickScore" ride
  the HF ``transformers`` CLIP implementation (imported only when such a
  scorer is built); "ImageReward" and "HPSv2" / "HPSv2.1" run the port's
  BLIP and OpenCLIP towers (``models/blip.py``, ``models/openclip.py``) and
  the port's CLIP BPE (``extensions/clip_bpe.py``).  Loading without the
  checkpoint or tokenizer files raises :class:`GatedMetricError` (before
  any weight is read) instead of downloading.
  MPS needs the bespoke cross-attention head and stays gated.
- **reference-free metrics** ("PSNR", "SSIM", "LPIPS") from
  ``eval/metrics.py``, wrapped in the same interface: they take a
  reference image instead of a prompt.

Every scorer runs on ``device`` (default ``"cuda"``); the JAX package's
``load_preference_model`` takes a ``device`` and ignores it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Metadata parity with the reference model_dict (ImageQualityMetric/
# __init__.py:21-133): modelscope repo + per-model file patterns.
MODEL_ID = "DiffSynth-Studio/QualityMetric_reward_pretrained"
model_dict = {
    "ImageReward": {"load_path": {
        "imagereward": "ImageReward/ImageReward.safetensors",
        "med_config": "ImageReward/med_config.json",
        "bert_model_path": "bert-base-uncased"}},
    "Aesthetic": {"load_path": {
        "aesthetic_predictor":
            "aesthetic-predictor/sac+logos+ava1-l14-linearMSE.safetensors",
        "clip-large": "clip-vit-large-patch14"}},
    "PickScore": {"load_path": {
        "pickscore": "PickScore_v1",
        "clip": "CLIP-ViT-H-14-laion2B-s32B-b79K"}},
    "CLIP": {"load_path": {"clip": "CLIP-ViT-H-14-laion2B-s32B-b79K"}},
    "HPSv2": {"load_path": {
        "hpsv2": "HPS_v2/HPS_v2_compressed.safetensors",
        "open_clip_bpe": "bpe_simple_vocab_16e6.txt.gz"}},
    "HPSv2.1": {"load_path": {
        "hpsv2.1": "HPS_v2/HPS_v2.1_compressed.safetensors",
        "open_clip_bpe": "bpe_simple_vocab_16e6.txt.gz"}},
    "MPS": {"load_path": {
        "mps": "MPS_overall_checkpoint/MPS_overall_checkpoint_diffsynth.safetensors"}},
    # reference-free additions (not in the reference registry)
    "PSNR": {"load_path": {}},
    "SSIM": {"load_path": {}},
    "LPIPS": {"load_path": {}},
}


class GatedMetricError(RuntimeError):
    pass


def download_preference_model(model_name: str, cache_dir: str = "models"):
    """Resolve local paths for a preference model.  Nothing is downloaded
    (the reference downloads through modelscope); missing files surface at
    load time."""
    meta = model_dict[model_name]
    return {key: os.path.join(cache_dir, MODEL_ID, rel)
            for key, rel in meta["load_path"].items()}


def _to_arrays(images):
    if not isinstance(images, (list, tuple)):
        images = [images]
    return [np.asarray(im, np.float32) / 255.0
            if np.asarray(im).dtype == np.uint8 else np.asarray(im, np.float32)
            for im in images]


class _ReferenceFreeScore:
    """PSNR/SSIM/LPIPS against a reference image (framework parity lane)."""

    def __init__(self, kind: str):
        self.kind = kind

    def score(self, images, reference):
        from physicedit_torch.eval import metrics as M

        fn = {"PSNR": M.psnr, "SSIM": M.ssim, "LPIPS": M.lpips}[self.kind]
        single = not isinstance(images, (list, tuple))
        imgs = _to_arrays(images)
        refs = _to_arrays(reference)
        if len(refs) == 1:
            refs = refs * len(imgs)
        outs = [fn(a, r) for a, r in zip(imgs, refs)]
        outs = [float(o) if o is not None else None for o in outs]
        return outs[0] if single else outs


class CLIPScore:
    """CLIP text-image cosine similarity via transformers, the same backbone
    the reference CLIPScore wraps through open_clip.

    ``processor_path`` lets a finetuned scoring model (PickScore) pair with
    the base CLIP processor (reference pickscore.py:17-20)."""

    def __init__(self, path: str, processor_path: str | None = None, device="cuda"):
        for p in {path, processor_path or path}:
            if not os.path.isdir(p):
                raise GatedMetricError(
                    f"CLIP checkpoint directory not found: {p} — preference "
                    f"models are not downloadable in this environment; "
                    f"place the HF folder there to enable this metric")
        from transformers import CLIPModel, CLIPProcessor

        self.device = torch.device(device)
        self.model = CLIPModel.from_pretrained(path).eval().to(self.device)
        self.processor = CLIPProcessor.from_pretrained(processor_path or path)

    def _inputs(self, **kw):
        return {k: v.to(self.device) for k, v in self.processor(**kw, return_tensors="pt").items()}

    def score(self, images, prompt: str):
        single = not isinstance(images, (list, tuple))
        if single:
            images = [images]
        with torch.no_grad():
            out = self.model(**self._inputs(text=[prompt], images=list(images), padding=True))
            img = out.image_embeds / out.image_embeds.norm(dim=-1, keepdim=True)
            txt = out.text_embeds / out.text_embeds.norm(dim=-1, keepdim=True)
            sims = (img @ txt.T).squeeze(-1).tolist()
        return sims[0] if single else sims


class AestheticScore(CLIPScore):
    """Linear aesthetic head over CLIP ViT-L/14 image features (reference
    aesthetic.py: sac+logos+ava1-l14-linearMSE)."""

    def __init__(self, path: str, head_path: str, device="cuda"):
        super().__init__(path, device=device)
        from physicedit_torch.io.safetensors_io import load_state_dict

        if not os.path.isfile(head_path):
            raise GatedMetricError(f"aesthetic head not found: {head_path}")
        self.head = {k: v.float().to(self.device) for k, v in load_state_dict(head_path).items()}

    def score(self, images, prompt: str = ""):
        single = not isinstance(images, (list, tuple))
        if single:
            images = [images]
        with torch.no_grad():
            feats = self.model.get_image_features(**self._inputs(images=list(images)))
            x = feats / feats.norm(dim=-1, keepdim=True)
            # Reference head (aesthetic.py MLP): a plain Linear chain at
            # Sequential indices {0, 2, 4, 6, 7}: dropout slots, NO
            # activations (the ReLUs are commented out upstream).
            idxs = sorted(int(k.split(".")[1]) for k in self.head if k.endswith(".weight"))
            for i in idxs:
                x = x @ self.head[f"layers.{i}.weight"].T
                if f"layers.{i}.bias" in self.head:
                    x = x + self.head[f"layers.{i}.bias"]
        scores = x.reshape(-1).tolist()
        return scores[0] if single else scores


class ImageRewardScore:
    """ImageReward: BLIP ViT-L/16 + med cross-encoder + MLP head
    (``models/blip.py``; reference imagereward.py:54-148).

    ``path``: the published ImageReward.safetensors (blip.* key space).
    ``bert_model_path``: folder with the bert-base-uncased tokenizer
    (imagereward tokenizes with padding='max_length', max_length=35).
    ``tokenizer``: injectable for tests.
    """

    MAX_LENGTH = 35

    def __init__(self, path: str, bert_model_path: str | None = None, tokenizer=None,
                 device="cuda"):
        from physicedit_torch.io.safetensors_io import load_state_dict
        from physicedit_torch.models import blip

        if not os.path.isfile(path):
            raise GatedMetricError(
                f"ImageReward checkpoint not found: {path} — preference "
                f"models are not downloadable in this environment; place "
                f"ImageReward.safetensors there to enable this metric")
        if tokenizer is None:
            if bert_model_path is None or not os.path.isdir(bert_model_path):
                raise GatedMetricError(
                    f"bert tokenizer folder not found: {bert_model_path}")
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(bert_model_path)
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.model, self.vit_cfg, self.txt_cfg = blip.imagereward_from_state_dict(
            load_state_dict(path), device=self.device)
        self._blip = blip

    def score(self, images, prompt: str = ""):
        enc = self.tokenizer(prompt, padding="max_length", truncation=True,
                             max_length=self.MAX_LENGTH)
        ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64).reshape(1, -1))
        mask = torch.as_tensor(np.asarray(enc["attention_mask"], np.int64).reshape(1, -1))
        single = not isinstance(images, (list, tuple))
        if single:
            images = [images]
        pixels = np.concatenate([self._blip.preprocess_blip(im, self.vit_cfg.image_size)
                                 for im in images])
        n = len(images)
        out = self._blip.imagereward_score(
            self.model, torch.from_numpy(pixels).to(self.device),
            ids.expand(n, -1).to(self.device), mask.expand(n, -1).to(self.device))
        scores = out.tolist()
        return scores[0] if single else scores


class HPScoreV2:
    """HPSv2 / HPSv2.1: OpenCLIP ViT-H/14 (``models/openclip.py``; reference
    hps.py:9-106).  Returns the raw normalised-feature diagonal similarity,
    as the reference does."""

    def __init__(self, path: str, bpe_path: str | None = None, tokenizer=None,
                 vision_heads=None, text_heads=None, device="cuda"):
        from physicedit_torch.io.safetensors_io import load_state_dict
        from physicedit_torch.models import openclip

        if not os.path.isfile(path):
            raise GatedMetricError(
                f"HPS checkpoint not found: {path} — preference models are "
                f"not downloadable in this environment; place the "
                f"compressed safetensors there to enable this metric")
        if tokenizer is None:
            if bpe_path is None or not os.path.isfile(bpe_path):
                raise GatedMetricError(f"CLIP BPE merges file not found: {bpe_path}")
            from physicedit_torch.extensions.clip_bpe import ClipBpeTokenizer

            tokenizer = ClipBpeTokenizer(bpe_path)
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.model, self.vision_cfg, self.text_cfg = openclip.openclip_from_state_dict(
            load_state_dict(path), vision_heads=vision_heads, text_heads=text_heads,
            device=self.device)
        self._openclip = openclip

    def score(self, images, prompt: str):
        ids = self.tokenizer.tokenize([prompt], context_length=self.text_cfg.context_length)
        single = not isinstance(images, (list, tuple))
        if single:
            images = [images]
        pixels = np.concatenate([self._openclip.preprocess_clip(im, self.vision_cfg.image_size)
                                 for im in images])
        ids = torch.as_tensor(np.asarray(ids, np.int64))
        sims = self._openclip.clip_similarity(
            self.model, torch.from_numpy(pixels).to(self.device),
            ids.expand(len(images), -1).to(self.device))
        scores = sims.tolist()
        return scores[0] if single else scores


def load_preference_model(model_name: str, device="cuda", path=None):
    """Reference API (ImageQualityMetric/__init__.py:144-148).  ``path`` is
    the dict returned by :func:`download_preference_model`; the scorer is
    placed on ``device``."""
    if model_name in ("PSNR", "SSIM", "LPIPS"):
        return _ReferenceFreeScore(model_name)
    path = path or download_preference_model(model_name)
    if model_name == "CLIP":
        return CLIPScore(path["clip"], device=device)
    if model_name == "PickScore":
        # finetuned CLIP-H weights, base CLIP-H processor (pickscore.py:17-20)
        return CLIPScore(path["pickscore"], processor_path=path["clip"], device=device)
    if model_name == "Aesthetic":
        return AestheticScore(path["clip-large"], path["aesthetic_predictor"], device=device)
    if model_name == "ImageReward":
        return ImageRewardScore(path["imagereward"], bert_model_path=path.get("bert_model_path"),
                                device=device)
    if model_name in ("HPSv2", "HPSv2.1"):
        key = "hpsv2" if model_name == "HPSv2" else "hpsv2.1"
        return HPScoreV2(path[key], bpe_path=path.get("open_clip_bpe"), device=device)
    raise GatedMetricError(
        f"{model_name} needs the bespoke MPS cross-attention head and "
        f"pretrained weights that are not downloadable in this environment "
        f"(documented divergence; every other registry entry loads from "
        f"local files)")
