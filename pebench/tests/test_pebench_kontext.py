"""The Kontext cell's pieces on the CPU: the runner's shapes at the cell's
traffic, the step's FLOP count against a hand count, the new metric
readers on a synthetic traced run, and a tiny Kontext cell end to end,
with ``context_dropped`` and the fp8 control failing its check."""

from __future__ import annotations

import json
import shutil

import pytest

from pebench import run as R
from pebench.control import control_run
from pebench.metrics import load as load_metric
from pebench.roofline import load as load_roofline
from pebench.tests.conftest import DATA
from pebench.tracing import TraceRun

CELL = "kontext-bf16-1024"


def cell_shapes() -> dict:
    bench = R.load_bench()
    config, traffic, runner = R.cell_files(bench, R.find_cell(bench, CELL))
    return runner.Runner(config, traffic, 2**33 + 5, "cpu").shapes()


def test_runner_shapes_at_the_cells_traffic():
    assert cell_shapes() == {
        "rows": 1, "img_tokens": 8192, "base": 4096, "txt": 512, "heads": 24, "head_dim": 128,
        "dim": 3072, "mlp_dim": 12288, "layers": 19, "single_layers": 38, "txt_in_dim": 4096,
        "pooled_dim": 768, "patch_dim": 64, "time_dim": 256}


def test_flux_step_flops_match_a_hand_count():
    """Both block kinds cost 12 d^2 MACs a token in their linears, plus the
    modulations; every block attends over the joint 8,704 tokens, the last
    single block's queries, MLP and output projection over the 4,096 target
    rows."""
    f = load_roofline("flux_step").step_flops(cell_shapes())
    d, s, base = 3072, 8704, 4096
    linears = 2 * (19 * (12 * d * d + 12 * d * d * s) + 37 * (3 * d * d + 12 * d * d * s)
                   + 3 * d * d + 3 * d * d * s + 9 * d * d * base)
    attention = 4 * d * (56 * s * s + base * s)
    assert f["block_linears"] == pytest.approx(linears, rel=1e-12)
    assert f["attention"] == pytest.approx(attention, rel=1e-12)
    # ISSUE-sized rounding: 57 x 12 x 3072^2 x 8704 x 2 and 57 x 4 x 8704^2 x 3072
    assert f["block_linears"] == pytest.approx(112.4e12, rel=0.01)
    assert f["attention"] == pytest.approx(53.05e12, rel=0.01)
    assert f["other"] < 1e-3 * linears
    least = load_roofline("flux_step").step_least_s(cell_shapes())
    assert least == pytest.approx(sum(f.values()) / 989e12)


def test_attention_bound_counts_every_k1_call():
    op = load_roofline("attn_fwd")
    want = 56 * op.call_bound_s(1, 24, 8704, 8704, 128) + op.call_bound_s(1, 24, 4096, 8704,
                                                                          128)
    assert load_roofline("flux_step").attn_step_bound_s(cell_shapes()) == pytest.approx(want)


def _synthetic_run() -> TraceRun:
    """Two traced steps: in each a single block's five segments launch a
    GEMM, the q/k kernel, K1, a GELU and a copy; a double block's qkv
    segment launches an elementwise kernel (not single-block glue)."""
    cpu, kernels, t = [], [], 0.0
    for _ in range(2):
        step0 = t
        cpu.append(("pe.denoise.step", step0, step0 + 100))
        cpu.append(("pe.dit", step0 + 1, step0 + 90))
        cpu.append(("pe.dit.block", step0 + 2, step0 + 10))
        cpu.append(("pe.block.qkv", step0 + 3, step0 + 9))
        cpu.append(("cudaLaunchKernel", step0 + 4, step0 + 5))
        kernels.append(("elementwise_kernel<bf16>", step0 + 200, step0 + 210))
        cpu.append(("pe.single.block", step0 + 20, step0 + 80))
        for seg, name, dur, at in (("qkv", "nvjet_tst_gemm", 30.0, 21),
                                   ("qkv", "qk_norm_rope_kernel", 4.0, 26),
                                   ("attn", "fixedmax_kernel<true>", 50.0, 31),
                                   ("mlp", "vectorized_elementwise_kernel<gelu>", 6.0, 41),
                                   ("out", "CatArrayBatchedCopy", 2.0, 51)):
            cpu.append((f"pe.single.{seg}", step0 + at, step0 + at + 4))
            cpu.append(("cudaLaunchKernel", step0 + at + 1, step0 + at + 2))
            start = step0 + 300 + at * 10
            kernels.append((name, start, start + dur))
        t += 1000
    cpu.sort(key=lambda x: x[1])
    kernels.sort(key=lambda k: k[1])
    shapes = cell_shapes()
    return TraceRun(kernels=kernels, window_s=2e-3, steps=2, shapes=shapes, busy_s=1.2e-3,
                    cpu=cpu, span=(0.0, 2000.0))


def test_kontext_metric_readers_on_a_synthetic_run():
    run = _synthetic_run()
    glue = load_metric("single_glue_ms.kontext")
    # the q/k kernel, the GELU and the copy; not the GEMM, K1 or the double block's kernel
    assert glue.by_segment(run) == pytest.approx(
        {"pe.single.qkv": 0.004, "pe.single.mlp": 0.006, "pe.single.out": 0.002})
    assert glue.read(run) == pytest.approx(0.012)
    assert load_metric("device_idle_pct.kontext").read(run) == pytest.approx(40.0)
    f = load_roofline("flux_step")
    assert load_metric("mfu.kontext").read(run) == pytest.approx(
        100 * f.step_least_s(run.shapes) * 2 / 2e-3)
    assert load_metric("attn_roofline.kontext").read(run) == pytest.approx(
        100 * f.attn_step_bound_s(run.shapes) * 2 / 100e-6)
    empty = TraceRun(kernels=[], window_s=1.0, steps=0, shapes=run.shapes)
    for name in ("mfu.kontext", "attn_roofline.kontext", "single_glue_ms.kontext",
                 "device_idle_pct.kontext"):
        assert load_metric(name).read(empty) is None


@pytest.fixture()
def kontext_root(tmp_path):
    for d in ("configs", "traffic"):
        (tmp_path / "pebench" / d).mkdir(parents=True)
    shutil.copy(DATA / "tiny-kontext.json", tmp_path / "pebench" / "configs" / "tiny-kontext.json")
    shutil.copy(DATA / "tiny-kontext-edit.json",
                tmp_path / "pebench" / "traffic" / "tiny-kontext-edit.json")
    return tmp_path


def kontext_bench() -> dict:
    return {"configs": [{"name": "tiny-kontext", "file": "pebench/configs/tiny-kontext.json"}],
            "workloads": [{"name": "cell-tiny-kontext", "config": "tiny-kontext",
                           "traffic": "tiny-kontext-edit", "chips": 1}],
            "end_to_end": [{"name": "edit_step_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "single_glue_ms.kontext", "unit": "ms"}]}


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_kontext_cell_runs_end_to_end(kontext_root, trace):
    res = R.run_cell(kontext_bench(), "cell-tiny-kontext", 2**33 + 7, 0.5, trace, device="cpu",
                     root=kontext_root)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0 and res["window"]["steps"] >= 3
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert set(res["checks"]) == {"dit_rel", "step_mismatch", "nonfinite_edits"}
    assert res["checks"]["step_mismatch"]["value"] == 0
    json.dumps(res)


def test_context_dropped_and_the_control_fail_the_tiny_check(kontext_root):
    """The tiny cell's limit lies between the sound reading and both the
    fault's and the control's (the keys' gain 4, as the cell sets it)."""
    bench = kontext_bench()
    (sound,) = control_run(bench, "cell-tiny-kontext", [31], [31], device="cpu",
                           root=kontext_root)
    (fault,) = control_run(bench, "cell-tiny-kontext", [31], [], device="cpu",
                           root=kontext_root, fault="context_dropped")
    limit = json.loads((DATA / "tiny-kontext.json").read_text())["limits"]["dit_rel"]
    assert sound["correct"] is True and sound["program"]["dit_rel"] < limit
    assert sound["control"]["dit_rel"] > limit
    assert fault["correct"] is False and fault["program"]["dit_rel"] > limit
    assert fault["program"]["step_mismatch"] == 0 and sound["rows_apart"] is None
