"""The training datasets (``physicedit_tpu/train/dataset.py``), host-side:
NumPy, PIL and, for videos, imageio (imported where a video is read).

- ``PhysicTranDataset``: PhysicTran38K.  It walks the root for leaf folders
  that hold videos; per leaf it reads ``unified_output_new_qwen.jsonl``
  keyed by the numeric video stem (prompt, state, transition, triplet, the
  stage_a principles and stage_b rule checks), drops the videos listed in
  ``final_filter_videos.txt``, and keeps the high-priority supported and
  contradicted rules.  An item decodes up to ``num_frames`` frames (crop
  and resize to the training size, or to at most ``max_pixels`` and /16),
  takes the median frame of each stride group as a middle key frame, and
  stitches a 2x3 preview: ``{image: last frame, edit_image: first frame,
  middle_key_frames, prompt: edit instruction, triplet, rules, ...}``.
- ``ImageEditDataset`` and ``VideoDataset``: metadata files (jsonl / json /
  csv) or folder scans pairing media with ``.txt`` prompts.
- ``Pica100kDataset``: PICA-100K from a local ``datasets`` folder.
- ``CachedPreprocessedDataset``: the ``.npz`` bundles of
  ``Trainer.cache_preprocessed``.
"""

from __future__ import annotations

import json
import os
import warnings
from pathlib import Path

import numpy as np


VIDEO_EXTS = {".mp4", ".avi", ".mov", ".wmv", ".mkv", ".flv", ".webm"}
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}


def import_imageio(path: str):
    """The imageio module, or an ImportError that names the video."""
    try:
        import imageio
    except ImportError as e:
        raise ImportError(f"decoding {path} needs imageio, which is not installed") from e
    return imageio


def crop_and_resize(image, target_height: int, target_width: int):
    """Scale-to-cover + center crop."""
    from PIL import Image

    width, height = image.size
    scale = max(target_width / width, target_height / height)
    image = image.resize((round(width * scale), round(height * scale)),
                         Image.BILINEAR)
    w, h = image.size
    left = (w - target_width) // 2
    top = (h - target_height) // 2
    return image.crop((left, top, left + target_width, top + target_height))


def fit_resolution(width: int, height: int, max_pixels: int,
                   factor: int = 16) -> tuple[int, int]:
    """Downscale to <= max_pixels and floor to /factor."""
    if width * height > max_pixels:
        scale = (width * height / max_pixels) ** 0.5
        height, width = int(height / scale), int(width / scale)
    height = max(factor, (height // factor) * factor)
    width = max(factor, (width // factor) * factor)
    return height, width


def extract_middle_key_frames(frames: list, stride: int = 8) -> list:
    """Median frame of each stride group over frames[1:-1]."""
    if len(frames) <= 2:
        return []
    middle = frames[1:-1]
    out = []
    for i in range(0, len(middle), stride):
        group = middle[i:i + stride]
        if group:
            out.append(group[len(group) // 2])
    return out


def stitch_grid(frames: list, cols: int = 2, rows: int = 3):
    """2x3 stitched preview of the 6 key frames."""
    from PIL import Image

    if len(frames) != cols * rows:
        return None
    w, h = frames[0].size
    grid = Image.new("RGB", (cols * w, rows * h))
    for i, im in enumerate(frames):
        if im.size != (w, h):
            im = im.resize((w, h))
        grid.paste(im, ((i % cols) * w, (i // cols) * h))
    return grid


def _high_priority_rules(meta: dict) -> list:
    rules = []
    principles = (meta.get("stage_a") or {}).get("principles") or []
    for i, p in enumerate(principles):
        if str(p.get("priority", "")).lower() != "high":
            continue
        rules.append({
            "id": str(p.get("id") or f"rule_{i}"),
            "instruction": str(p.get("instruction", "")).strip(),
            "visual_cues": [str(c).strip() for c in (p.get("visual_cues") or [])
                            if str(c).strip()],
            "negations": [str(n).strip() for n in (p.get("negations") or [])
                          if str(n).strip()],
        })
    return rules


def _supported_contradicted(meta: dict, high_rules: list) -> tuple[list, list]:
    checks = {rc.get("id", ""): rc
              for rc in (meta.get("stage_b") or {}).get("rule_checks", [])}
    supported, contradicted = [], []
    for r in high_rules:
        rc = checks.get(r["id"], {})
        result = str(rc.get("result", "unknown")).lower()
        if result == "supported":
            supported.append({"id": r["id"], "instruction": r["instruction"],
                              "matched_cues": rc.get("matched_cues", [])})
        elif result == "contradicted":
            contradicted.append({"id": r["id"], "instruction": r["instruction"]})
    return supported, contradicted


class PhysicTranDataset:
    """Iterable/indexable PhysicTran38K sample source."""

    METADATA_FILE = "unified_output_new_qwen.jsonl"
    FILTER_FILE = "final_filter_videos.txt"

    def __init__(self, root_dir: str, num_frames: int = 49,
                 max_pixels: int = 1920 * 1080,
                 height: int | None = None, width: int | None = None,
                 key_frame_stride: int = 8, repeat: int = 1,
                 require_meta: bool = True):
        self.root = Path(root_dir)
        self.num_frames = num_frames
        self.max_pixels = max_pixels
        self.height, self.width = height, width
        self.key_frame_stride = key_frame_stride
        self.repeat = repeat
        self.require_meta = require_meta
        self.samples = self._scan()
        if not self.samples:
            warnings.warn("PhysicTranDataset: no valid samples found")

    # -- indexing ------------------------------------------------------

    def _scan(self) -> list:
        samples = []
        for cur, subdirs, files in os.walk(self.root):
            leaf = Path(cur)
            videos = sorted(f for f in files
                            if Path(f).suffix.lower() in VIDEO_EXTS)
            if not videos:
                continue
            subdirs[:] = []

            meta_map = {}
            meta_path = leaf / self.METADATA_FILE
            if meta_path.exists():
                for line in meta_path.read_text(encoding="utf-8").splitlines():
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                        meta_map[int(obj["idx"])] = obj
                    except (ValueError, KeyError, TypeError):
                        continue

            excluded = set()
            filt = leaf / self.FILTER_FILE
            if filt.exists():
                excluded = {l.strip() for l in
                            filt.read_text(encoding="utf-8").splitlines()
                            if l.strip()}

            for name in videos:
                if name in excluded:
                    continue
                stem = Path(name).stem
                if not stem.isdigit():
                    continue
                meta = meta_map.get(int(stem))
                if meta is None:
                    if self.require_meta:
                        continue
                    meta = {}
                high = _high_priority_rules(meta)
                supported, contradicted = _supported_contradicted(meta, high)
                samples.append({
                    "path": str((leaf / name).resolve()),
                    "idx": int(stem),
                    "prompt": meta.get("edit_instruction", ""),
                    "original_prompt": meta.get("prompt", ""),
                    "state": meta.get("state", ""),
                    "transition": meta.get("transition", ""),
                    "triplet": meta.get("triplet", {}),
                    "supported_rules": supported,
                    "contradicted_rules": contradicted,
                })
        samples.sort(key=lambda s: (str(Path(s["path"]).parent), s["idx"]))
        return samples

    # -- decoding ------------------------------------------------------

    def _load_frames(self, path: str) -> list:
        from PIL import Image

        imageio = import_imageio(path)
        try:
            reader = imageio.get_reader(path)
        except Exception as e:  # noqa: BLE001 — corrupt files must not kill training
            warnings.warn(f"cannot open video {path}: {e}")
            return []
        frames = []
        try:
            for i, frame in enumerate(reader):
                if i >= self.num_frames:
                    break
                img = Image.fromarray(frame).convert("RGB")
                if self.height is not None and self.width is not None:
                    h, w = self.height, self.width
                else:
                    h, w = fit_resolution(img.size[0], img.size[1], self.max_pixels)
                frames.append(crop_and_resize(img, h, w))
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"error reading {path}: {e}")
        finally:
            reader.close()
        return frames

    def __len__(self):
        return len(self.samples) * self.repeat

    def __getitem__(self, i: int):
        rec = self.samples[i % len(self.samples)]
        frames = self._load_frames(rec["path"])
        if not frames:
            return None
        keys = extract_middle_key_frames(frames, self.key_frame_stride)
        return {
            **rec,
            "image": frames[-1],
            "edit_image": frames[0],
            "middle_key_frames": keys,
            "stitched_image": stitch_grid(keys),
        }


class ImageEditDataset:
    """Generic (image, edit_image, prompt) dataset from a metadata file.

    The reference ImageDataset at the feature level: jsonl/csv metadata
    with image/edit_image/prompt columns, or a directory of paired image +
    .txt prompt files.
    """

    def __init__(self, base_path: str, metadata_path: str | None = None,
                 height: int | None = None, width: int | None = None,
                 max_pixels: int = 1024 * 1024, repeat: int = 1):
        self.base = Path(base_path)
        self.height, self.width, self.max_pixels = height, width, max_pixels
        self.repeat = repeat
        self.records = self._load_metadata(metadata_path)

    def _load_metadata(self, metadata_path):
        records = []
        if metadata_path is None:
            for p in sorted(self.base.rglob("*")):
                if p.suffix.lower() in IMAGE_EXTS:
                    txt = p.with_suffix(".txt")
                    prompt = txt.read_text().strip() if txt.exists() else ""
                    # base-RELATIVE like metadata records: __getitem__
                    # joins self.base back on (a str(p) here would
                    # double-join under a relative base_path)
                    records.append({"image": str(p.relative_to(self.base)),
                                    "prompt": prompt})
            return records
        from physicedit_torch.train.unified_dataset import load_metadata_records

        return load_metadata_records(metadata_path)

    def __len__(self):
        return len(self.records) * self.repeat

    def __getitem__(self, i: int):
        from PIL import Image

        rec = dict(self.records[i % len(self.records)])
        for key in ("image", "edit_image"):
            if key in rec and isinstance(rec[key], str):
                img = Image.open(self.base / rec[key]).convert("RGB")
                if self.height is not None and self.width is not None:
                    h, w = self.height, self.width
                else:
                    h, w = fit_resolution(img.size[0], img.size[1], self.max_pixels)
                rec[key] = crop_and_resize(img, h, w)
        return rec


class Pica100kDataset:
    """PICA-100K editing pairs (``Andrew613/PICA-100K``) from a local
    ``datasets.save_to_disk`` folder: each record's source image, target
    image and prompt, as ``{image: target, edit_image: source, prompt}``
    cropped and resized to the training size.  The hub path of the JAX
    package needs a download and is not ported: ``local_dataset_path`` is
    required."""

    def __init__(self, dataset_id: str = "Andrew613/PICA-100K",
                 split: str = "train", height: int | None = None,
                 width: int | None = None, max_pixels: int = 1024 * 1024,
                 prompt_column: str = "prompt",
                 local_dataset_path: str | None = None):
        if local_dataset_path is None:
            raise ValueError(f"Pica100kDataset reads a local copy of {dataset_id} ({split}): "
                             "pass local_dataset_path (a datasets.save_to_disk folder)")
        from datasets import load_from_disk

        self.ds = load_from_disk(local_dataset_path)
        self.height, self.width, self.max_pixels = height, width, max_pixels
        self.prompt_column = prompt_column

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        rec = self.ds[i]
        src = rec["source_image"].convert("RGB")
        tgt = rec["target_image"].convert("RGB")
        if self.height is not None and self.width is not None:
            h, w = self.height, self.width
        else:
            h, w = fit_resolution(tgt.size[0], tgt.size[1], self.max_pixels)
        prompt = rec.get(self.prompt_column) or rec.get("prompt", "")
        return {
            "image": crop_and_resize(tgt, h, w),
            "edit_image": crop_and_resize(src, h, w),
            "middle_key_frames": [],
            "prompt": prompt,
            "triplet": {},
            "supported_rules": [], "contradicted_rules": [],
        }


class VideoDataset:
    """Generic video/image dataset with folder-scan metadata generation.

    The reference VideoDataset at the feature level: json/csv metadata or
    auto-generated (media file + sibling .txt prompt), frame-count fitting to ``num_frames % time_division_factor
    == time_division_remainder``, dynamic resolution capped at max_pixels
    and floored to /16, GIF variable-delay resampling.  Decoding is done by
    the operator DSL (train/unified_dataset.py) so behaviour is shared with
    UnifiedDataset.
    """

    def __init__(self, base_path: str | None = None,
                 metadata_path: str | None = None, num_frames: int = 81,
                 time_division_factor: int = 4, time_division_remainder: int = 1,
                 max_pixels: int = 1920 * 1080,
                 height: int | None = None, width: int | None = None,
                 height_division_factor: int = 16,
                 width_division_factor: int = 16,
                 data_file_keys: tuple = ("video",), repeat: int = 1):
        from physicedit_torch.train import unified_dataset as U

        if base_path is None:
            raise ValueError("VideoDataset requires base_path")
        self.base = Path(base_path)
        self.data_file_keys = tuple(data_file_keys)
        self.repeat = repeat
        self.loader = U.UnifiedDataset.default_video_operator(
            base_path=base_path or "", max_pixels=max_pixels,
            height=height, width=width,
            height_division_factor=height_division_factor,
            width_division_factor=width_division_factor,
            num_frames=num_frames,
            time_division_factor=time_division_factor,
            time_division_remainder=time_division_remainder)
        self.records = self._load_metadata(metadata_path)

    def _generate_metadata(self) -> list:
        """Pair media files with sibling .txt prompts."""
        records = []
        names = set(os.listdir(self.base))
        media_exts = VIDEO_EXTS | IMAGE_EXTS | {".gif"}
        for name in sorted(names):
            p = Path(name)
            if p.suffix.lower() not in media_exts:
                continue
            txt = p.stem + ".txt"
            if txt not in names:
                continue
            prompt = (self.base / txt).read_text(encoding="utf-8").strip()
            records.append({"video": name, "prompt": prompt})
        return records

    def _load_metadata(self, metadata_path):
        if metadata_path is None:
            return self._generate_metadata()
        from physicedit_torch.train.unified_dataset import load_metadata_records

        return load_metadata_records(metadata_path)

    def __len__(self):
        return len(self.records) * self.repeat

    def __getitem__(self, i: int):
        rec = dict(self.records[i % len(self.records)])
        for key in self.data_file_keys:
            if key in rec and isinstance(rec[key], str):
                try:
                    rec[key] = self.loader(rec[key])
                except (ValueError, OSError) as e:
                    warnings.warn(f"cannot load {rec[key]}: {e}")
                    return None
        return rec


class CachedPreprocessedDataset:
    """Read back `.npz` bundles written by Trainer.cache_preprocessed —
    the consume side of the reference's data-process task
   .  Use with TrainConfig(cached_inputs=True).
    """

    def __init__(self, cache_dir: str, repeat: int = 1):
        self.paths = sorted(Path(cache_dir).glob("*.npz"))
        if not self.paths:
            raise ValueError(f"no cached samples under {cache_dir}")
        self.repeat = repeat

    def __len__(self):
        return len(self.paths) * self.repeat

    def __getitem__(self, i: int):
        with np.load(self.paths[i % len(self.paths)], allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
