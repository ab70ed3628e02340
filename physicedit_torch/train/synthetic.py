"""Synthetic data in the PhysicTran38K layout, for the tests and the card
run of ``chip_smoke.py``:

    <root>/clips/
      0.mp4 ... {n + excluded - 1}.mp4
      unified_output_new_qwen.jsonl    one record per video (idx = the stem)
      final_filter_videos.txt          the last ``excluded`` videos

Each video is ``frames`` frames of a square that slides and brightens over
a gradient, with a little noise, made from a seed.  ``encode="stand-in"``
stores the frames with ``np.save`` under the video's name, and
:func:`stand_in_reader` puts :class:`StandInReader` in place of
``imageio.get_reader`` so that both packages' ``_load_frames`` decode them
(their crops and resizes included) where imageio has no mp4 backend;
``encode="imageio"`` writes real mp4 files through imageio.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import types

import numpy as np

from physicedit_torch.train.dataset import PhysicTranDataset


def video_frames(i: int, frames: int, width: int, height: int, seed: int = 0) -> np.ndarray:
    """[frames, height, width, 3] uint8 frames of video ``i``."""
    rng = np.random.default_rng(seed + i)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, 0.5 + 0.0 * x], -1) * 160.0 + 40.0 * (i % 3)
    side = max(4, min(width, height) // 4)
    out = np.empty((frames, height, width, 3), np.uint8)
    for t in range(frames):
        f = base.copy()
        x0 = int((width - side) * t / max(frames - 1, 1))
        y0 = (height - side) // 2
        f[y0:y0 + side, x0:x0 + side] = 80.0 + 170.0 * t / max(frames - 1, 1)
        f += rng.normal(0.0, 4.0, f.shape)
        out[t] = np.clip(f, 0, 255).astype(np.uint8)
    return out


def metadata_record(i: int) -> dict:
    """The metadata line of video ``i``: instruction, triplet, one high- and
    one low-priority principle and their rule checks."""
    return {
        "idx": i, "edit_instruction": f"push box {i} off the shelf so that it falls",
        "prompt": f"a box {i} on a shelf", "state": "resting", "transition": "falling",
        "triplet": {"middle_transition_prompt": "the box tips over the edge and drops",
                    "final_state_prompt": "the box lies on the floor"},
        "stage_a": {"principles": [
            {"id": "gravity", "priority": "high", "instruction": "objects fall down",
             "visual_cues": ["box lower in later frames", " "], "negations": ["box floats"]},
            {"id": "shadow", "priority": "low", "instruction": "the shadow follows"}]},
        "stage_b": {"rule_checks": [
            {"id": "gravity", "result": "supported" if i % 2 == 0 else "contradicted",
             "matched_cues": ["box lower in later frames"]}]},
    }


def write_physictran_tree(root: str, n: int = 4, excluded: int = 1, frames: int = 49,
                          width: int = 832, height: int = 480, seed: int = 0,
                          encode: str = "stand-in") -> list:
    """Write ``n`` videos that the dataset keeps and ``excluded`` that its
    filter file drops; returns the kept videos' paths."""
    leaf = os.path.join(root, "clips")
    os.makedirs(leaf, exist_ok=True)
    paths = []
    for i in range(n + excluded):
        path = os.path.join(leaf, f"{i}.mp4")
        arr = video_frames(i, frames, width, height, seed)
        if encode == "imageio":
            import imageio

            with imageio.get_writer(path, fps=8) as w:
                for frame in arr:
                    w.append_data(frame)
        elif encode == "stand-in":
            with open(path, "wb") as f:
                np.save(f, arr)
        else:
            raise ValueError(f"encode {encode!r}: 'stand-in' or 'imageio'")
        paths.append(path)
    with open(os.path.join(leaf, PhysicTranDataset.METADATA_FILE), "w") as f:
        for i in range(n + excluded):
            f.write(json.dumps(metadata_record(i)) + "\n")
    with open(os.path.join(leaf, PhysicTranDataset.FILTER_FILE), "w") as f:
        f.write("".join(f"{i}.mp4\n" for i in range(n, n + excluded)))
    return paths[:n]


class StandInReader:
    """``imageio.get_reader``'s interface over a file of ``np.save`` frames."""

    def __init__(self, path, *args, **kwargs):
        self.frames = np.load(path)

    def __iter__(self):
        return iter(self.frames)

    def count_frames(self) -> int:
        return len(self.frames)

    def close(self) -> None:
        pass


@contextlib.contextmanager
def stand_in_reader():
    """``imageio.get_reader`` replaced by :class:`StandInReader` in the
    block (a stand-in module when imageio is not installed)."""
    try:
        import imageio
    except ImportError:
        sys.modules["imageio"] = types.SimpleNamespace(get_reader=StandInReader)
        try:
            yield
        finally:
            del sys.modules["imageio"]
        return
    real = imageio.get_reader
    imageio.get_reader = StandInReader
    try:
        yield
    finally:
        imageio.get_reader = real
