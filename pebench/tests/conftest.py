"""Shared fixtures of the benchmark's tests: a tiny checkout layout on the
CPU (the tests' configurations and traffic under ``tmp/pebench/``) and a
benchmark table of its cells."""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
TINY_CONFIGS = ("tiny-bf16", "tiny-w4")


def tiny_bench() -> dict:
    return {
        "configs": [{"name": n, "file": f"pebench/configs/{n}.json"} for n in TINY_CONFIGS],
        "workloads": [{"name": f"cell-{n}", "config": n, "traffic": "tiny-edit", "chips": 1}
                      for n in TINY_CONFIGS],
        "end_to_end": [{"name": "edit_step_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "device_idle_pct.edit", "unit": "%"}],
    }


@pytest.fixture()
def tiny_root(tmp_path) -> Path:
    for d in ("configs", "traffic"):
        (tmp_path / "pebench" / d).mkdir(parents=True)
    for n in TINY_CONFIGS:
        shutil.copy(DATA / f"{n}.json", tmp_path / "pebench" / "configs" / f"{n}.json")
    shutil.copy(DATA / "tiny-edit.json", tmp_path / "pebench" / "traffic" / "tiny-edit.json")
    return tmp_path
