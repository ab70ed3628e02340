"""One per-layer metric a file, ``metrics/<name>.py``, found by the name in
``BENCHMARK.json``.  Each defines ``read(run)`` over a ``trace.TraceRun``
and returns a number, or None when the run holds nothing to read (then
the metric is left out of the result)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    module = f"pebench_metric_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
