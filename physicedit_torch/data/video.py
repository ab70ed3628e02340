"""User-facing video / image-folder IO: the port's own copy of
``physicedit_tpu/data/video.py`` (host-side: NumPy, PIL and, for encoded
videos only, imageio).

Rebuilds the reference's public ``diffsynth.data`` surface
(``DiffSynth-Studio/diffsynth/data/video.py:9-217``, re-exported from the
package root at ``diffsynth/__init__.py:1``): lazy frame access over an
encoded video or a numbered image folder, center-crop-to-aspect resizing,
and mp4/frame/audio writers.

All of this is host-side Python (PIL + imageio + ffmpeg) — frames only
become device arrays when a pipeline or processor chain asks for them, so
nothing here touches the card. Decoding is lazy per frame (the reference calls
these "LowMemory" readers) so a 49-frame 1080p clip never materialises as
a single array on the host.

imageio is imported only where an encoded video is read or written (a
missing imageio raises an ``ImportError`` that names the file); image
folders and PNG frames need PIL alone.

Divergences from the reference, on purpose:
- natural sort uses a regex digit-run split rather than a per-character
  scan (same ordering — proven by a transliteration test);
- readers are context managers and close deterministically instead of
  relying on ``__del__``;
- ``tqdm`` is optional (progress bars only if it is importable);
- ``merge_video_audio`` raises on failure instead of printing and
  swallowing the error (reference video.py:209-212 hides the failure and
  leaves the caller with a silent no-audio file).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np
from PIL import Image

__all__ = [
    "LowMemoryVideo",
    "LowMemoryImageFolder",
    "VideoData",
    "crop_and_resize",
    "search_for_images",
    "save_video",
    "save_frames",
    "merge_video_audio",
    "save_video_with_audio",
]

_IMAGE_SUFFIXES = (".jpg", ".png")


def _progress(iterable, desc):
    try:  # pragma: no cover - cosmetic only
        from tqdm import tqdm

        return tqdm(iterable, desc=desc)
    except Exception:  # noqa: BLE001 - tqdm genuinely optional
        return iterable


def import_imageio(path):
    """The imageio module, or an ImportError that names the video."""
    try:
        import imageio
    except ImportError as e:
        raise ImportError(f"{path} needs imageio, which is not installed") from e
    return imageio


def _natural_key(file_name):
    """Sort key treating digit runs as numbers: frame2 < frame10.

    Same ordering as the reference's split_file_name (video.py:23-39),
    which interleaves digit-run integers with the characters around them.
    """
    parts = re.split(r"(\d+)", file_name)
    key = []
    for p in parts:
        if not p:
            continue
        if p.isdigit():
            key.append((0, int(p), ""))
        else:
            # Expand a text run to per-character elements so that ordering
            # matches the reference's character-by-character tuple compare.
            key.extend((1, 0, c) for c in p)
    return tuple(key)


def search_for_images(folder):
    """Numbered-aware listing of .jpg/.png files (reference video.py:42-47)."""
    names = [n for n in os.listdir(folder) if n.endswith(_IMAGE_SUFFIXES)]
    names.sort(key=_natural_key)
    return [os.path.join(folder, n) for n in names]


class LowMemoryVideo:
    """Lazy per-frame reader over an encoded video file (video.py:9-20)."""

    def __init__(self, file_name):
        self.reader = import_imageio(file_name).get_reader(file_name)

    def _live_reader(self):
        if self.reader is None:
            raise ValueError("reader is closed (LowMemoryVideo used after "
                             "close() / context exit)")
        return self.reader

    def __len__(self):
        return self._live_reader().count_frames()

    def __getitem__(self, item):
        return Image.fromarray(
            np.asarray(self._live_reader().get_data(item))).convert("RGB")

    def close(self):
        reader = getattr(self, "reader", None)
        if reader is not None:
            reader.close()
            self.reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class LowMemoryImageFolder:
    """Lazy reader over a folder of numbered frames (video.py:50-64)."""

    def __init__(self, folder, file_list=None):
        if file_list is None:
            self.file_list = search_for_images(folder)
        else:
            self.file_list = [os.path.join(folder, n) for n in file_list]

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, item):
        with Image.open(self.file_list[item]) as im:
            return im.convert("RGB")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def crop_and_resize(image, height, width):
    """Center-crop to the target aspect ratio, then resize.

    Same geometry as the reference (video.py:67-80): crop the axis that is
    too long relative to height/width, centered, then PIL-resize to the
    exact target.
    """
    arr = np.asarray(image)
    ih, iw = arr.shape[0], arr.shape[1]
    if ih * width < height * iw:  # too wide -> crop width
        crop_w = int(ih / height * width)
        left = (iw - crop_w) // 2
        arr = arr[:, left : left + crop_w]
    else:  # too tall -> crop height
        crop_h = int(iw / width * height)
        top = (ih - crop_h) // 2
        arr = arr[top : top + crop_h, :]
    return Image.fromarray(arr).resize((width, height))


class VideoData:
    """Uniform lazy view over a video file OR an image folder.

    Reference video.py:83-137. ``height``/``width`` (when set) apply
    :func:`crop_and_resize` per frame on access; ``set_length`` truncates
    the logical length without touching the underlying reader.
    """

    def __init__(self, video_file=None, image_folder=None, height=None, width=None, **kwargs):
        if video_file is not None:
            self.data_type = "video"
            self.data = LowMemoryVideo(video_file, **kwargs)
        elif image_folder is not None:
            self.data_type = "images"
            self.data = LowMemoryImageFolder(image_folder, **kwargs)
        else:
            raise ValueError("Cannot open video or image folder")
        self.length = None
        self.set_shape(height, width)

    def set_length(self, length):
        self.length = length

    def set_shape(self, height, width):
        self.height = height
        self.width = width

    def __len__(self):
        return len(self.data) if self.length is None else self.length

    def shape(self):
        if self.height is not None and self.width is not None:
            return self.height, self.width
        first = np.asarray(self[0])
        return first.shape[0], first.shape[1]

    def __getitem__(self, item):
        frame = self.data[item]
        w, h = frame.size
        if self.height is not None and self.width is not None:
            if (self.height, self.width) != (h, w):
                frame = crop_and_resize(frame, self.height, self.width)
        return frame

    def raw_data(self):
        return [self[i] for i in range(len(self))]

    def save_images(self, folder):
        os.makedirs(folder, exist_ok=True)
        for i in _progress(range(len(self)), "Saving images"):
            self[i].save(os.path.join(folder, f"{i}.png"))

    def close(self):
        self.data.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_video(frames, save_path, fps, quality=9, ffmpeg_params=None):
    """Encode a frame sequence to a video file (reference video.py:140-145)."""
    writer = import_imageio(save_path).get_writer(save_path, fps=fps, quality=quality,
                                                  ffmpeg_params=ffmpeg_params)
    try:
        for frame in _progress(frames, "Saving video"):
            writer.append_data(np.asarray(frame))
    finally:
        writer.close()


def save_frames(frames, save_path):
    """Dump frames as ``{i}.png`` into a folder (reference video.py:147-150)."""
    os.makedirs(save_path, exist_ok=True)
    for i, frame in enumerate(_progress(frames, "Saving images")):
        frame.save(os.path.join(save_path, f"{i}.png"))


def merge_video_audio(video_path, audio_path):
    """Mux an audio track into an existing video file, in place.

    Same ffmpeg recipe as the reference (video.py:175-194): copy the video
    stream, AAC-encode the audio at 192k, ``-shortest``. Unlike the
    reference we raise on failure rather than printing and leaving a
    silent file behind.
    """
    if not os.path.exists(video_path):
        raise FileNotFoundError(f"video file {video_path} does not exist")
    if not os.path.exists(audio_path):
        raise FileNotFoundError(f"audio file {audio_path} does not exist")
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("merge_video_audio requires the ffmpeg binary on PATH")

    base, ext = os.path.splitext(video_path)
    temp_output = f"{base}_temp{ext}"
    command = [
        "ffmpeg", "-y",
        "-i", video_path,
        "-i", audio_path,
        "-c:v", "copy",
        "-c:a", "aac",
        "-b:a", "192k",
        "-map", "0:v:0",
        "-map", "1:a:0",
        "-shortest",
        temp_output,
    ]
    try:
        result = subprocess.run(command, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"ffmpeg failed: {result.stderr}")
        shutil.move(temp_output, video_path)
    finally:
        if os.path.exists(temp_output):
            os.remove(temp_output)


def save_video_with_audio(frames, save_path, audio_path, fps=16, quality=9, ffmpeg_params=None):
    """save_video + merge_video_audio in one call (reference video.py:215-217)."""
    save_video(frames, save_path, fps, quality=quality, ffmpeg_params=ffmpeg_params)
    merge_video_audio(save_path, audio_path)
