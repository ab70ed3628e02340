"""One op class a file: its operations and bytes from the shapes of one
step, and the kernel-name patterns whose device time it is divided by.
``load(name)`` finds ``roofline/<name>.py``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    module = f"pebench_roofline_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def least_time(flops: float, bytes_: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, bytes_ / peak_bytes)
