"""The data-processing operators and ``UnifiedDataset``
(``physicedit_tpu/train/unified_dataset.py``).

Operators compose with ``op1 >> op2``; ``RouteByType`` and
``RouteByExtensionName`` pick a branch.  PIL does the image geometry,
imageio the video decode (imported where a video is read), ``.npz`` holds
cached preprocessed tensors (``.pth`` files load through ``torch.load``).
Everything here runs on the host, in the loader threads
(``train/prefetch.py``); nothing touches the card.
"""

from __future__ import annotations

import json
import os

import numpy as np

from physicedit_torch.train.dataset import import_imageio, crop_and_resize, fit_resolution

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "bmp")
VIDEO_EXTS = ("mp4", "avi", "mov", "wmv", "mkv", "flv", "webm")


class DataProcessingPipeline:
    """A chain of operators; ``pipe >> op`` appends."""

    def __init__(self, operators=None):
        self.operators = [] if operators is None else list(operators)

    def __call__(self, data):
        for op in self.operators:
            data = op(data)
        return data

    def __rshift__(self, other):
        if isinstance(other, DataProcessingOperator):
            other = DataProcessingPipeline([other])
        return DataProcessingPipeline(self.operators + other.operators)


class DataProcessingOperator:
    def __call__(self, data):
        raise NotImplementedError

    def __rshift__(self, other):
        return DataProcessingPipeline([self]).__rshift__(other)


class Raw(DataProcessingOperator):
    def __call__(self, data):
        return data


class ToInt(DataProcessingOperator):
    def __call__(self, data):
        return int(data)


class ToFloat(DataProcessingOperator):
    def __call__(self, data):
        return float(data)


class ToStr(DataProcessingOperator):
    def __init__(self, none_value=""):
        self.none_value = none_value

    def __call__(self, data):
        return str(self.none_value if data is None else data)


class ToList(DataProcessingOperator):
    def __call__(self, data):
        return [data]


class ToAbsolutePath(DataProcessingOperator):
    def __init__(self, base_path=""):
        self.base_path = base_path

    def __call__(self, data):
        return os.path.join(self.base_path, data)


class LoadImage(DataProcessingOperator):
    def __init__(self, convert_RGB=True):
        self.convert_RGB = convert_RGB

    def __call__(self, path: str):
        from PIL import Image

        image = Image.open(path)
        return image.convert("RGB") if self.convert_RGB else image


class ImageCropAndResize(DataProcessingOperator):
    """Aspect-preserving cover-resize + centre crop.

    With height/width unset, resolution is dynamic: capped at max_pixels and
    floored to the division factors.
    """

    def __init__(self, height=None, width=None, max_pixels=1920 * 1080,
                 height_division_factor=16, width_division_factor=16):
        self.height, self.width = height, width
        self.max_pixels = max_pixels
        self.hdiv, self.wdiv = height_division_factor, width_division_factor

    def target_size(self, image):
        if self.height is None or self.width is None:
            w, h = image.size
            # shared helper keeps the >= division-factor floor (a 3000x12
            # banner would otherwise round to a 0-height target)
            th, _ = fit_resolution(w, h, self.max_pixels, self.hdiv)
            _, tw = fit_resolution(w, h, self.max_pixels, self.wdiv)
            return th, tw
        return self.height, self.width

    def __call__(self, image):
        th, tw = self.target_size(image)
        return crop_and_resize(image, th, tw)


class SequentialProcess(DataProcessingOperator):
    def __init__(self, operator=lambda x: x):
        self.operator = operator

    def __call__(self, data):
        return [self.operator(x) for x in data]


def _fit_num_frames(available: int, num_frames: int,
                    division_factor: int, remainder: int) -> int:
    """Largest n <= available with n % factor == remainder."""
    n = min(num_frames, available)
    while n > 1 and n % division_factor != remainder:
        n -= 1
    return n


class LoadVideo(DataProcessingOperator):
    def __init__(self, num_frames=81, time_division_factor=4,
                 time_division_remainder=1, frame_processor=lambda x: x):
        self.num_frames = num_frames
        self.tdiv = time_division_factor
        self.trem = time_division_remainder
        self.frame_processor = frame_processor

    def __call__(self, path: str):
        from PIL import Image

        reader = import_imageio(path).get_reader(path)
        try:
            try:
                available = int(reader.count_frames())
            except Exception:  # noqa: BLE001 — some containers can't count
                available = self.num_frames
            n = _fit_num_frames(available, self.num_frames, self.tdiv, self.trem)
            frames = []
            for i, frame in enumerate(reader):
                if i >= n:
                    break
                frames.append(self.frame_processor(
                    Image.fromarray(frame).convert("RGB")))
            if len(frames) < n:
                # count_frames() was unavailable/wrong and the file ran
                # short: re-fit so the divisibility contract still holds
                frames = frames[: _fit_num_frames(len(frames), self.num_frames,
                                                  self.tdiv, self.trem)]
            return frames
        finally:
            reader.close()


class LoadGIF(DataProcessingOperator):
    """GIF loader with variable-delay resampling to a uniform frame
    interval: when frame durations differ, frames are re-sampled at the
    minimal positive delay so motion speed is preserved."""

    def __init__(self, num_frames=81, time_division_factor=4,
                 time_division_remainder=1, frame_processor=lambda x: x):
        self.num_frames = num_frames
        self.tdiv = time_division_factor
        self.trem = time_division_remainder
        self.frame_processor = frame_processor

    def __call__(self, path: str):
        from PIL import Image

        gif = Image.open(path)
        delays, frames = [], []
        idx = 0
        while True:
            delays.append(gif.info.get("duration", 100))
            frames.append(self.frame_processor(gif.convert("RGB")))
            idx += 1
            try:
                gif.seek(idx)
            except EOFError:
                break
        if any(d != delays[0] for d in delays):
            interval = min(d for d in delays if d > 0)
            starts = np.cumsum([0] + delays)
            resampled = []
            for t in range(0, starts[-1], interval):
                j = int(np.searchsorted(starts, t, side="right")) - 1
                resampled.append(frames[min(j, len(frames) - 1)])
            frames = resampled
        n = _fit_num_frames(len(frames), self.num_frames, self.tdiv, self.trem)
        return frames[:n]


class RouteByExtensionName(DataProcessingOperator):
    def __init__(self, operator_map):
        self.operator_map = operator_map

    def __call__(self, path: str):
        ext = path.split(".")[-1].lower()
        for exts, op in self.operator_map:
            if exts is None or ext in exts:
                return op(path)
        raise ValueError(f"Unsupported file: {path}")


class RouteByType(DataProcessingOperator):
    def __init__(self, operator_map):
        self.operator_map = operator_map

    def __call__(self, data):
        for dtype, op in self.operator_map:
            if dtype is None or isinstance(data, dtype):
                return op(data)
        raise ValueError(f"Unsupported data: {data!r}")


class LoadCachedTensors(DataProcessingOperator):
    """Load preprocessed tensors: ``.npz`` as NumPy arrays, ``.pth`` (the
    reference's torch pickles) through ``torch.load`` on the CPU."""

    def __call__(self, path: str):
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=True) as z:
                return {k: z[k] for k in z.files}
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)


def load_metadata_records(metadata_path) -> list:
    """json / jsonl / csv metadata -> list of dict rows (the shared parser
    for UnifiedDataset, VideoDataset and ImageEditDataset)."""
    path = str(metadata_path)
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]
    if path.endswith(".csv"):
        import csv

        with open(path, newline="") as f:
            return list(csv.DictReader(f))
    raise ValueError(f"unsupported metadata format: {path}")


class UnifiedDataset:
    """Metadata-driven dataset applying an operator pipeline per file key.

    Modes:
    - metadata_path json/jsonl/csv: rows are dicts; each key in
      ``data_file_keys`` is run through ``special_operator_map.get(key,
      main_data_operator)``.
    - metadata_path None: recursively collect cached ``.npz``/``.pth``
      files under base_path and return their tensors.
    """

    def __init__(self, base_path=None, metadata_path=None, repeat=1,
                 data_file_keys=(), main_data_operator=lambda x: x,
                 special_operator_map=None):
        self.base_path = base_path
        self.repeat = repeat
        self.data_file_keys = tuple(data_file_keys)
        self.main_data_operator = main_data_operator
        self.special_operator_map = special_operator_map or {}
        self.cached_data_operator = LoadCachedTensors()
        self.data, self.cached_data = [], []
        self.load_from_cache = metadata_path is None
        self._load_metadata(metadata_path)

    @staticmethod
    def default_image_operator(base_path="", max_pixels=1920 * 1080,
                               height=None, width=None,
                               height_division_factor=16,
                               width_division_factor=16):
        resize = ImageCropAndResize(height, width, max_pixels,
                                    height_division_factor, width_division_factor)
        single = ToAbsolutePath(base_path) >> LoadImage() >> resize
        return RouteByType([(str, single), (list, SequentialProcess(single))])

    @staticmethod
    def default_video_operator(base_path="", max_pixels=1920 * 1080,
                               height=None, width=None,
                               height_division_factor=16,
                               width_division_factor=16,
                               num_frames=81, time_division_factor=4,
                               time_division_remainder=1):
        resize = ImageCropAndResize(height, width, max_pixels,
                                    height_division_factor, width_division_factor)
        return RouteByType([(str, ToAbsolutePath(base_path) >> RouteByExtensionName([
            (IMAGE_EXTS, LoadImage() >> resize >> ToList()),
            (("gif",), LoadGIF(num_frames, time_division_factor,
                               time_division_remainder, frame_processor=resize)),
            (VIDEO_EXTS, LoadVideo(num_frames, time_division_factor,
                                   time_division_remainder,
                                   frame_processor=resize)),
        ]))])

    def _search_cached(self, path):
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isdir(sub):
                self._search_cached(sub)
            elif sub.endswith((".npz", ".pth")):
                self.cached_data.append(sub)

    def _load_metadata(self, metadata_path):
        if metadata_path is None:
            self._search_cached(self.base_path)
        else:
            self.data = load_metadata_records(metadata_path)

    def __getitem__(self, i):
        if self.load_from_cache:
            return self.cached_data_operator(
                self.cached_data[i % len(self.cached_data)])
        data = dict(self.data[i % len(self.data)])
        for key in self.data_file_keys:
            if key in data:
                op = self.special_operator_map.get(key, self.main_data_operator)
                data[key] = op(data[key])
        return data

    def __len__(self):
        n = len(self.cached_data) if self.load_from_cache else len(self.data)
        return n * self.repeat
