"""ModelConfig: model-source descriptors with an optional download
(``physicedit_tpu/io/model_config.py``).

``ModelConfig`` names ``{model_id, origin_file_pattern, local_model_path,
skip_download}`` (the reference's ``diffsynth/utils/__init__.py:160-220``);
``download_if_necessary`` resolves the glob pattern against a local tree and,
when a downloader library is importable (``modelscope``, else
``huggingface_hub``), fetches what is missing.  Only rank 0 of an
initialised ``torch.distributed`` group downloads; the others wait at a
barrier.  Without a downloader the gate stays closed and a missing file is a
``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import glob
import os


@dataclasses.dataclass
class ModelConfig:
    path: str | list | None = None
    model_id: str | None = None
    origin_file_pattern: str | None = None
    local_model_path: str = "./models"
    skip_download: bool = False
    offload_dtype: object | None = None

    def download_if_necessary(self):
        if self.path is not None:
            return self.path
        if self.model_id is None:
            raise ValueError(
                "ModelConfig needs either `path` or (`model_id`, "
                "`origin_file_pattern`)")

        target_dir = os.path.join(self.local_model_path, self.model_id)
        pattern = self.origin_file_pattern or ""
        is_folder = pattern == "" or pattern.endswith("/")

        def resolve():
            if is_folder:
                p = os.path.join(target_dir, pattern)
                return p if os.path.isdir(p) else None
            hits = sorted(glob.glob(os.path.join(target_dir, pattern)))
            return (hits[0] if len(hits) == 1 else hits) if hits else None

        found = resolve()
        if found is None and not self.skip_download:
            self._download(target_dir, pattern, is_folder)
            found = resolve()
        if found is None:
            raise FileNotFoundError(
                f"model files not found: {target_dir}/{pattern}")
        self.path = found
        return self.path

    def _download(self, target_dir: str, pattern: str, is_folder: bool):
        allow = (pattern + "*") if is_folder and pattern else (pattern or None)
        is_main = _process_index() == 0
        if is_main:
            try:
                from modelscope import snapshot_download

                snapshot_download(self.model_id, local_dir=target_dir,
                                  allow_file_pattern=allow)
            except ImportError:
                try:
                    from huggingface_hub import snapshot_download

                    snapshot_download(self.model_id, local_dir=target_dir,
                                      allow_patterns=[allow] if allow else None)
                except ImportError:
                    raise FileNotFoundError(
                        f"{self.model_id} not present locally and no download "
                        "library (modelscope / huggingface_hub) is available; "
                        "pass `path=` to a local copy") from None
        _barrier()


# ---------------------------------------------------------------------------
# Preset rows: the Qwen-Image family by name.
#
# Mirrors the reference's by-name model resolution for the PhysicEdit
# stack (scripts/inference/validate.py:94-125 assembles exactly these
# (model_id, origin_file_pattern) rows; the generic preset machinery is
# configs/model_config.py:15-33).  Pure data — downloads stay gated on a
# hub library being importable (ModelConfig._download above).
# ---------------------------------------------------------------------------

_QI = "Qwen/Qwen-Image"
_QIE = "Qwen/Qwen-Image-Edit"
_QIE2509 = "Qwen/Qwen-Image-Edit-2509"
_TEXT_ROW = (_QI, "text_encoder/model*.safetensors")
_VAE_ROW = (_QI, "vae/diffusion_pytorch_model.safetensors")
_TOKENIZER_ROW = (_QI, "tokenizer/")
_PROCESSOR_ROW = (_QIE, "processor/")

QWEN_IMAGE_PRESETS = {
    # PhysicEdit's base model (validate.py:98-124, inference_pica.py,
    # inference_kris.py): Edit-2509 transformer + Qwen-Image encoder/VAE.
    _QIE2509: {
        "model_configs": [
            (_QIE2509, "transformer/diffusion_pytorch_model*.safetensors"),
            _TEXT_ROW, _VAE_ROW,
        ],
        "tokenizer": _TOKENIZER_ROW,
        "processor": _PROCESSOR_ROW,
    },
    # First-generation edit model (same satellite files).
    _QIE: {
        "model_configs": [
            (_QIE, "transformer/diffusion_pytorch_model*.safetensors"),
            _TEXT_ROW, _VAE_ROW,
        ],
        "tokenizer": _TOKENIZER_ROW,
        "processor": _PROCESSOR_ROW,
    },
    # Text-to-image base (no edit processor).
    _QI: {
        "model_configs": [
            (_QI, "transformer/diffusion_pytorch_model*.safetensors"),
            _TEXT_ROW, _VAE_ROW,
        ],
        "tokenizer": _TOKENIZER_ROW,
        "processor": None,
    },
}


def qwen_image_preset(model_id: str, local_model_path: str = "./models",
                      skip_download: bool = False) -> dict:
    """Resolve a Qwen-Image family name into its ModelConfig rows.

    Returns {"model_configs": [ModelConfig, ...], "tokenizer_config":
    ModelConfig, "processor_config": ModelConfig | None}.  Raises KeyError
    with the known names for an unknown id.
    """
    if model_id not in QWEN_IMAGE_PRESETS:
        raise KeyError(
            f"unknown preset model_id {model_id!r}; known presets: "
            f"{sorted(QWEN_IMAGE_PRESETS)}")
    rows = QWEN_IMAGE_PRESETS[model_id]

    def mk(row):
        mid, pattern = row
        return ModelConfig(model_id=mid, origin_file_pattern=pattern,
                           local_model_path=local_model_path,
                           skip_download=skip_download)

    return {
        "model_configs": [mk(r) for r in rows["model_configs"]],
        "tokenizer_config": mk(rows["tokenizer"]),
        "processor_config": (mk(rows["processor"])
                             if rows["processor"] else None),
    }


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
