"""The operation and byte counts against the bounds PERF.md's kernel table
gives at the same shapes, the step's FLOP count, and the per-layer readers
over a synthetic trace."""

from __future__ import annotations

import pytest

from pebench import metrics, peaks
from pebench.roofline import load
from pebench.tracing import TraceRun, busy_seconds, breakdown

EDIT = {"rows": 2, "img_tokens": 8192, "base": 4096, "txt_valid": [603, 271],
        "txt_padded": 640, "heads": 24, "head_dim": 128, "dim": 3072, "mlp_dim": 12288,
        "layers": 60, "txt_in_dim": 3584, "patch_dim": 64, "time_dim": 256,
        "adapter_dim": 3584, "specials": 64, "quantize": None}


def test_k1_bound_at_b2_n24_s8448():
    assert round(load("attn_fwd").call_bound_s(2, 24, 8448, 8448, 128) * 1e3, 3) == 1.773


def test_k8_bound_at_b1_n24_s3504():
    assert round(load("attn_bwd").call_bound_s(1, 24, 3504, 128) * 1e3, 3) == 0.381


def test_k3_bound_at_16384_3072_12288():
    assert round(load("w4_gemm").call_bound_s(16384, 12288, 3072) * 1e3, 3) == 0.625


def test_k3_gemv_is_bound_by_bytes():
    m, n, k = 2, 18432, 3072
    t = load("w4_gemm").call_bound_s(m, n, k)
    assert t > 2.0 * m * n * k / peaks.INT8_OPS
    assert t == pytest.approx((n * k / 2 + 4 * n + m * k + 4 * m + 2 * m * n + 2 * n)
                              / peaks.HBM_BYTES_PER_S)


def test_edit_step_flops():
    f = load("dit_step").step_flops(EDIT)
    # block GEMMs ~240 TFLOP and joint attention ~110 TFLOP a CFG step at joint 8832
    assert 230e12 < f["block_linears"] < 250e12
    assert 340e12 < f["block_linears"] + f["other"] < 370e12
    w4 = dict(EDIT, quantize="int4")
    assert load("dit_step").step_least_s(w4) < load("dit_step").step_least_s(EDIT)


def test_attention_step_bound_counts_every_block():
    op = load("attn_fwd")
    full = [op.call_bound_s(1, 24, t + 8192, t + 8192, 128) for t in (603, 271)]
    slim = [op.call_bound_s(1, 24, 4096, t + 8192, 128) for t in (603, 271)]
    assert op.step_bound_s(EDIT) == pytest.approx(59 * sum(full) + sum(slim))


def _run(kernels, window_s=1.0, steps=2, shapes=EDIT):
    return TraceRun(kernels=kernels, window_s=window_s, steps=steps, shapes=shapes,
                    busy_s=busy_seconds([(s, e) for _, s, e in kernels]),
                    span=(0.0, window_s * 1e6))


def test_readers_return_nothing_without_device_events():
    run = _run([])
    for name in ("mfu.edit", "attn_roofline.edit", "w4_gemm_roofline",
                 "launches_per_step.edit", "device_idle_pct.edit"):
        assert metrics.load(name).read(run) is None


def test_readers_on_a_synthetic_trace():
    op = load("attn_fwd")
    t_k1 = op.step_bound_s(EDIT) * 2 / 0.5          # K1 at half its roofline
    kernels = [("void fixedmax_kernel<false>", 0.0, t_k1 * 1e6),
               ("elementwise_kernel", t_k1 * 1e6, t_k1 * 1e6 + 1e5),
               ("Memcpy HtoD", t_k1 * 1e6 + 2e5, t_k1 * 1e6 + 3e5)]
    window = t_k1 + 0.5
    run = _run(kernels, window_s=window)
    assert metrics.load("attn_roofline.edit").read(run) == pytest.approx(50.0)
    assert metrics.load("launches_per_step.edit").read(run) == 1.0
    idle = metrics.load("device_idle_pct.edit").read(run)
    assert idle == pytest.approx(100 * (1 - (t_k1 + 0.2) / window))
    mfu = metrics.load("mfu.edit").read(run)
    assert mfu == pytest.approx(100 * load("dit_step").step_least_s(EDIT) * 2 / window)
    assert metrics.load("w4_gemm_roofline").read(run) is None
    b = breakdown(run)
    assert b["device_ops"][0][0].startswith("void fixedmax_kernel")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_busy_seconds_is_the_union():
    assert busy_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
