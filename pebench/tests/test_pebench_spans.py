"""The program's spans in a traced run (``pebench/spans.py``) on synthetic
profiler events: the tracer's parse left as it was, launch calls paired with
device events kind by kind, each kernel put down to the innermost ``pe.``
span open at its launch, and the three readers of the spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from pebench import metrics
from pebench import spans as S
from pebench.tracing import TraceRun, Tracer

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN_READERS = ("block_glue_ms.edit", "loop_ms.edit", "launch_lead_ms.edit")


class Events:
    """Profiler events: ``op`` a host op (a program span is one), ``kernel``
    a launch call on the host and the device event it enqueued."""

    def __init__(self):
        self.events = []

    def _event(self, name, s, e, device=CPU):
        self.events.append(SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                                           device_type=device))

    def op(self, name, s, e):
        self._event(name, s, e)

    def kernel(self, name, s, e, launched_at=None, call="cudaLaunchKernel"):
        if launched_at is not None:
            self._event(call, launched_at, launched_at + 0.5)
        self._event(name, s, e, CUDA)


def _run(events, t0=0.0, t1=1.0, steps=1) -> TraceRun:
    tracer = Tracer(torch.device("cpu"))
    tracer.prof = SimpleNamespace(events=lambda: events.events)
    tracer.t0, tracer.t1, tracer.steps = t0, t1, steps
    return tracer.run({})


def _one_step(ev: Events, start: float, lag: float):
    """One denoise step from ``start`` on the host: the adapter, the DiT
    with one block (a GEMM, two glue kernels, the attention launched from
    outside any op, as K1 is), then the CFG combine; each kernel runs
    ``lag`` after its launch."""
    ev.op("pe.denoise.step", start, start + 90)
    ev.op("pe.denoise.adapter", start + 1, start + 10)
    ev.op("aten::add", start + 2, start + 3)
    ev.kernel("elementwise_kernel", start + 2 + lag, start + 4 + lag, start + 2.2)
    ev.op("pe.dit", start + 11, start + 80)
    ev.op("pe.dit.block", start + 12, start + 70)
    ev.op("pe.block.mod", start + 13, start + 20)
    ev.op("aten::addmm", start + 14, start + 15)
    ev.kernel("nvjet_tst_gemm", start + 14 + lag, start + 24 + lag, start + 14.2,
              "cuLaunchKernelEx")
    ev.op("pe.block.attn", start + 21, start + 40)
    ev.op("aten::cat", start + 22, start + 23)
    ev.kernel("CatArrayBatchedCopy", start + 24 + lag, start + 27 + lag, start + 22.2)
    ev.kernel("fixedmax_kernel", start + 27 + lag, start + 57 + lag, start + 30)
    ev.op("pe.block.mlp", start + 41, start + 69)
    ev.op("aten::gelu", start + 42, start + 43)
    ev.kernel("vectorized_elementwise_kernel", start + 57 + lag, start + 62 + lag,
              start + 42.2)
    ev.op("aten::sub", start + 81, start + 82)
    ev.kernel("elementwise_kernel", start + 85 + lag, start + 86 + lag, start + 81.2)


def _owners(run):
    sp = S.of(run)
    return [sp.spans[o][0] if o >= 0 else None for o in sp.owners]


def test_program_spans_leave_the_parse_as_it_was():
    plain, spanned = Events(), Events()
    for ev in (plain, spanned):
        ev.op("pebench.window", 0, 1000)
        ev.op("aten::add", 11, 12)
        ev.kernel("elementwise_kernel", 20, 30, 11.5)
        ev.kernel("Memcpy HtoD", 30, 35, 13, "cudaMemcpyAsync")
        ev.kernel("Command Buffer Full", 30, 40)
    spanned.op("pe.dit", 10, 100)
    a, b = _run(plain), _run(spanned)
    assert a.kernels == b.kernels == [("elementwise_kernel", 20, 30), ("Memcpy HtoD", 30, 35)]
    assert a.launches() == b.launches() == 1
    assert a.busy_s == b.busy_s == pytest.approx(15e-6)
    assert a.span == b.span == (0, 1000)
    assert _owners(a) == [None, None] and _owners(b) == ["pe.dit", "pe.dit"]
    for name in SPAN_READERS:
        assert metrics.load(name).read(a) is None


def test_kernels_go_to_the_span_open_at_their_launch():
    ev = Events()
    ev.op("pebench.window", 0, 1000)
    _one_step(ev, 100, lag=5)
    # a copy between the launches is paired with its own call
    ev.op("pe.denoise.adapter", 200, 210)
    ev.kernel("Memcpy HtoD (Pageable -> Device)", 250, 251, 205, "cudaMemcpyAsync")
    ev.events.reverse()      # the profiler gives no order
    run = _run(ev)
    by_name = dict(zip(run.kernels, _owners(run)))
    assert by_name == {
        ("elementwise_kernel", 107, 109): "pe.denoise.adapter",
        ("nvjet_tst_gemm", 119, 129): "pe.block.mod",
        ("CatArrayBatchedCopy", 129, 132): "pe.block.attn",
        ("fixedmax_kernel", 132, 162): "pe.block.attn",
        ("vectorized_elementwise_kernel", 162, 167): "pe.block.mlp",
        ("elementwise_kernel", 190, 191): "pe.denoise.step",
        ("Memcpy HtoD (Pageable -> Device)", 250, 251): "pe.denoise.adapter"}
    sp = S.of(run)
    names = [s[0] for s in sp.spans]
    parents = {(s[0], s[1]): names[s[3]] if s[3] >= 0 else None for s in sp.spans}
    assert parents == {("pe.denoise.step", 100): None,
                       ("pe.denoise.adapter", 101): "pe.denoise.step",
                       ("pe.dit", 111): "pe.denoise.step", ("pe.dit.block", 112): "pe.dit",
                       ("pe.block.mod", 113): "pe.dit.block",
                       ("pe.block.attn", 121): "pe.dit.block",
                       ("pe.block.mlp", 141): "pe.dit.block",
                       ("pe.denoise.adapter", 200): None}
    gemm = run.kernels.index(("nvjet_tst_gemm", 119, 129))
    assert list(sp.chain(sp.owners[gemm])) == ["pe.block.mod", "pe.dit.block", "pe.dit",
                                               "pe.denoise.step"]
    assert S.of(run) is sp


@pytest.mark.parametrize("fault", ["a kernel with no call", "a call with no kernel",
                                   "a copy with no call"])
def test_a_kind_that_does_not_pair_is_left_unowned(fault):
    ev = Events()
    ev.op("pebench.window", 0, 1000)
    ev.op("pe.dit", 10, 100)
    ev.kernel("gemm", 20, 30, 11)
    ev.kernel("Memcpy DtoH", 40, 41, 12, "cudaMemcpyAsync")
    if fault == "a kernel with no call":
        ev.kernel("elementwise_kernel", 50, 60)
    elif fault == "a call with no kernel":
        ev.op("cudaLaunchKernel", 13, 14)
    else:
        ev.kernel("Memcpy HtoD", 45, 46)
    run = _run(ev)
    owners = dict(zip((k[0] for k in run.kernels), _owners(run)))
    copies_pair = fault != "a copy with no call"
    assert owners["Memcpy DtoH"] == ("pe.dit" if copies_pair else None)
    assert owners["gemm"] == (None if copies_pair else "pe.dit")
    # the parse itself reads as before
    assert run.launches() == (2 if fault == "a kernel with no call" else 1)


def test_the_owner_is_the_span_still_open():
    ev = Events()
    ev.op("pe.dit", 0, 100)
    ev.op("pe.dit.block", 10, 20)
    ev.op("pe.dit.block", 30, 40)
    for t in (5, 15, 25, 35, 100, 150):
        ev.kernel("k", 200 + t, 201 + t, t)
    run = _run(ev)
    sp = S.of(run)
    assert [s[3] for s in sp.spans] == [-1, 0, 0]
    assert sp.owners == [0, 1, 0, 2, 0, -1]


def test_readers_of_the_spans():
    ev = Events()
    ev.op("pebench.window", 50, 1000)
    # steps at 0 (cut by the window), 200, 400 (whole), 950 (cut)
    for start, lag in ((0, 9), (200, 30), (400, 50), (950, 5)):
        _one_step(ev, start, lag)
    run = _run(ev, steps=4)
    steps = S.whole_steps(run)
    assert [s for s, _ in steps] == [200, 400]
    assert all(len(k) == 6 for _, k in steps)
    assert [in_dit for _, _, _, in_dit in steps[0][1]] == [False, True, True, True, True, False]
    # glue: the cat (3 us) and the GELU (5 us) of each of the four DiT calls
    glue = metrics.load("block_glue_ms.edit")
    assert glue.by_segment(run) == pytest.approx({"pe.block.attn": 3e-3, "pe.block.mlp": 5e-3})
    assert glue.read(run) == pytest.approx(8e-3)
    # the loop: the adapter's kernel (2 us) and the combine (1 us) a whole step
    assert metrics.load("loop_ms.edit").read(run) == pytest.approx(3e-3)
    # a step's first kernel starts 2 us + its lag after the step's span
    assert metrics.load("launch_lead_ms.edit").read(run) == pytest.approx(
        (32e-3 + 52e-3) / 2)


def test_a_step_open_when_the_profiler_stopped_is_not_whole():
    ev = Events()
    ev.op("pebench.window", 0, 1000)
    _one_step(ev, 100, 5)
    # the profiler gives a range it never saw close an end of its own making
    ev.op("pe.denoise.step", 500, 501)
    ev.op("aten::add", 502, 503)
    ev.kernel("elementwise_kernel", 510, 511, 502.5)
    run = _run(ev)
    steps = S.whole_steps(run)
    assert [s for s, _ in steps] == [100]
    assert len(steps[0][1]) == 6


def test_readers_need_whole_steps():
    ev = Events()
    ev.op("pebench.window", 50, 150)
    _one_step(ev, 0, 5)
    run = _run(ev)
    assert S.whole_steps(run) == []
    assert metrics.load("loop_ms.edit").read(run) is None
    assert metrics.load("launch_lead_ms.edit").read(run) is None
    assert metrics.load("block_glue_ms.edit").read(TraceRun([], 1.0, 0, {})) is None
