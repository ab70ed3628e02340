"""The harness end to end on the CPU at a tiny size, its refusal without a
card, and the guard against JAX in the process."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from pebench import run as R
from pebench.tests.conftest import tiny_bench


@pytest.mark.parametrize("cell", ["cell-tiny-bf16", "cell-tiny-w4"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_end_to_end(tiny_root, cell, trace):
    res = R.run_cell(tiny_bench(), cell, 2**33 + 7, 0.5, trace, device="cpu", root=tiny_root)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    # the runner's window fields pass through under its own names
    assert res["window"]["attempted"] == res["attempted"] and res["window"]["steps"] >= 3
    # no device metric from a CPU run, timed or traced
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    for name in ("dit_rel", "rows_rel", "step_mismatch", "nonfinite_edits"):
        c = res["checks"][name]
        assert c["value"] <= c["limit"]
    json.dumps(res)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "edit-bf16-1024", "--seed", "5", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "needs 1 CUDA device" in out.err


def test_main_refuses_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = R.main(["--workload", "edit-w4-1024", "--seed", "5", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("physicedit_tpu", True), ("physicedit_tpu.models.dit", True),
    ("physicedit_torch", False), ("physicedit_torch.models.dit", False),
    ("jaxtyping", False), ("flaxen", False), ("physicedit_tpu_extra", False),
])
def test_forbidden_modules_compares_top_level_names_whole(name, found):
    assert (R.forbidden_modules({name: None}) == [name]) is found


def test_guard_fails_the_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax.fake_for_test", object())
    with pytest.raises(SystemExit) as exc:
        R._guard("after the window")
    assert exc.value.code == 3
    assert "jax.fake_for_test" in capsys.readouterr().err


def test_pebench_imports_no_jax():
    """The harness, its reference and the port's modules a run loads pull
    in nothing of JAX (a fresh process, as a run is)."""
    import subprocess

    code = ("import sys; sys.path.insert(0, '.'); from pebench import run, control, tracing; "
            "from pebench.runners import edit_denoise; "
            "import physicedit_torch.pipeline.edit_pipeline; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=R.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
