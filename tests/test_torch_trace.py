"""The program's spans (``physicedit_torch/core/trace.py``) on the CPU: off
and free without a profiler, and under ``torch.profiler`` one of each per
denoise step, per DiT call, per block and per block segment, with every op
of a block inside a segment and the outputs unchanged."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from physicedit_torch.core import trace
from physicedit_torch.ops import rope as m_rope
from physicedit_torch.pipeline.testing import build_random_pipeline
from physicedit_torch.sampling import flow_match as fm

torch.set_num_threads(2)

SEGMENTS = ("pe.block.mod", "pe.block.qkv", "pe.block.attn", "pe.block.out", "pe.block.mlp")
STEPS = 2


@pytest.fixture(scope="module", params=[None, "int4"])
def pipe(request):
    return build_random_pipeline("tiny", device="cpu", generator=torch.Generator().manual_seed(3),
                                 quantize=request.param)


def _denoise(pipe, steps: int = STEPS):
    """A tiny CFG edit's denoise through ``_run_denoise`` (timed, with the
    adapter's rewrite): a 32 x 32 output beside a 32 x 32 edit image."""
    g = torch.Generator().manual_seed(0)
    lat, d = 4, pipe.dit.cfg.txt_in_dim
    img_shapes = [(1, lat // 2, lat // 2), (1, lat // 2, lat // 2)]
    s_t, valid = 16, (14, 9)
    rows = torch.randn(2, s_t, d, generator=g).numpy()
    mask = np.zeros((2, s_t), bool)
    for r, n in enumerate(valid):
        rows[r, n:] = 0
        mask[r, :n] = True
    specials = [np.arange(2, 6), np.arange(1, 5)]
    sched = fm.build_schedule(steps, fm.QWEN_IMAGE_CONFIG, dynamic_shift_len=lat * lat // 4)
    ropes = m_rope.build_rope_tables(img_shapes, s_t, axes_dim=pipe.rope_axes)
    noise = torch.randn(1, lat, lat, 16, generator=g)
    extra = torch.randn(1, lat * lat // 4, pipe.dit.cfg.patch_dim, generator=g)
    return pipe._run_denoise(noise, extra, rows, mask, specials, ropes, sched, 4.0, (lat, lat),
                             None)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]


def _chain(ev):
    names = []
    ev = ev.cpu_parent
    while ev is not None:
        names.append(ev.name)
        ev = ev.cpu_parent
    return names


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened with no profiler")

    monkeypatch.setattr(trace, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = trace.span("pe.a"), trace.span("pe.b")
    assert a is b
    with a:
        with b:
            pass


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("pe.outer"):
            with trace.span("pe.inner"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()}
    assert events["pe.inner"].cpu_parent.name == "pe.outer"
    assert events["aten::ones"].cpu_parent.name == "pe.inner"
    # a host op, not a user annotation: the profiler makes no device-side
    # copy of it to stand among the kernels
    assert not events["pe.outer"].is_user_annotation
    # off again once the profiler stops
    assert trace.span("pe.after") is trace.span("pe.again")


def test_denoise_records_each_span_once_a_step(pipe):
    _, events = _profiled(lambda: _denoise(pipe))
    counts = collections.Counter(e.name for e in events if e.name.startswith("pe."))
    layers = len(pipe.dit.blocks)
    want = {"pe.stage.denoise": 1, "pe.denoise.step": STEPS, "pe.denoise.adapter": STEPS,
            "pe.dit": STEPS, "pe.dit.block": STEPS * layers,
            **{name: STEPS * layers for name in SEGMENTS}}
    assert dict(counts) == want
    # the slim last block has its five segments too
    last = [e for e in events if e.name == "pe.dit.block"][-1]
    assert sorted(e.name for e in last.cpu_children) == sorted(SEGMENTS)
    step = next(e for e in events if e.name == "pe.denoise.step")
    assert _chain(step) == ["pe.stage.denoise"]
    assert {e.name for e in step.cpu_children} >= {"pe.denoise.adapter", "pe.dit"}


def test_every_op_of_a_block_is_in_a_segment(pipe):
    _, events = _profiled(lambda: _denoise(pipe))
    in_blocks = 0
    for ev in events:
        if not ev.name.startswith("aten::"):
            continue
        chain = _chain(ev)
        if "pe.dit.block" in chain:
            in_blocks += 1
            spans = [n for n in chain if n.startswith("pe.")]
            assert spans[0] in SEGMENTS and spans[1] == "pe.dit.block", (ev.name, chain)
    assert in_blocks > 0


def test_spans_change_no_output(pipe):
    plain = _denoise(pipe)
    traced, _ = _profiled(lambda: _denoise(pipe))
    assert torch.equal(plain, traced)


def test_timed_records_the_stage_span_and_fills_timings(pipe):
    pipe.timings = {}

    def stage():
        with pipe._timed("denoise"):
            torch.ones(8).sum()

    _, events = _profiled(stage)
    spans = [e for e in events if e.name == "pe.stage.denoise"]
    assert len(spans) == 1
    assert any(e.name.startswith("aten::") for e in spans[0].cpu_children)
    assert pipe.timings["denoise"] > 0.0
    stage()
    assert set(pipe.timings) == {"denoise"}
