"""A configuration, a traffic mix and a per-layer metric added as new files
are found by name, with no file of the benchmark edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from pebench import run as R
from pebench.tests.conftest import DATA

SNIPPET = r"""
import json, sys
from pathlib import Path
from pebench import metrics, run as R
from pebench.tracing import TraceRun
root = Path.cwd()
bench = R.load_bench(root)
cell = R.find_cell(bench, "added-cell")
config, traffic, runner = R.cell_files(bench, cell, root)
names = [m["name"] for m in R.cell_metrics(bench, cell, "per_layer")]
run = TraceRun(kernels=[("k", 0.0, 10.0)], window_s=1.0, steps=3, shapes={})
values = {n: metrics.load(n).read(run) for n in names if n == "added_metric"}
res = R.run_cell(bench, "added-cell", 99, 0.2, False, device="cpu", root=root)
print(json.dumps({"config": config["name"], "traffic": traffic["runner"],
                  "metrics": names, "values": values, "correct": res["correct"],
                  "pebench": str(Path(R.__file__).resolve().parent)}))
"""


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(R.HERE, tmp_path / "pebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "pebench")

    pb = tmp_path / "pebench"
    shutil.copy(DATA / "tiny-bf16.json", pb / "configs" / "added-config.json")
    shutil.copy(DATA / "tiny-edit.json", pb / "traffic" / "added-traffic.json")
    (pb / "metrics" / "added_metric.py").write_text(
        "def read(run):\n    return float(run.steps) if run.kernels else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "added-config", "source": "test",
                             "file": "pebench/configs/added-config.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "added-cell", "config": "added-config",
                               "traffic": "added-traffic", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "added_metric", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "edit_step_ms", "workloads": ["added-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(R.ROOT)]))
    out = subprocess.run([sys.executable, "-c", SNIPPET], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["pebench"] == str(pb)
    assert got["config"] == "tiny-bf16" and got["traffic"] == "edit_denoise"
    assert got["metrics"] == ["added_metric"] and got["values"] == {"added_metric": 3.0}
    assert got["correct"] is True
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/added-config.json", "metrics/added_metric.py", "traffic/added-traffic.json"]
