"""The program's spans in a traced run, read from what ``tracing.TraceRun``
holds: the host events (``cpu``) and the device events (``kernels``).

The port opens its spans (``pe.<layer>[.<part>]``,
``physicedit_torch/core/trace.py``) as host ops, so they stand in ``cpu``
beside the CUDA calls that enqueue the device's work.  A kernel belongs to
the innermost span open on the host when its launch call ran.  The run
keeps no CUPTI ids, so launch calls and device events are paired in order,
kind by kind (kernels, copies, fills): the edit enqueues from one thread
onto one stream, so the n-th launch call of a kind is the n-th device event
of that kind.  Where the counts of a kind differ, that kind is left
unpaired and its kernels belong to no span.

A span still open when the profiler stops gets an end of the profiler's
making, so a denoise step counts as whole from its start to the next
step's start, and only the steps the profiler saw open and see followed.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

PREFIX = "pe."
STEP = "pe.denoise.step"
DIT = "pe.dit"
SEGMENT = "pe.block."
# host calls that enqueue one device event each, by the kind of that event
CALLS = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel"),
         "copy": ("cudaMemcpy", "cuMemcpy"),
         "fill": ("cudaMemset", "cuMemset")}


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def _host_kind(name: str):
    for kind, prefixes in CALLS.items():
        if name.startswith(prefixes):
            return kind
    return None


@dataclass
class Spans:
    """``spans``: (name, start_us, end_us, parent index or -1) in order of
    start; ``launched``: per kernel of ``run.kernels`` the host start of its
    launch call, or None; ``owners``: per kernel its innermost span, or -1."""
    spans: list
    launched: list
    owners: list

    def chain(self, i: int):
        """The names from span ``i`` up to its outermost parent."""
        while i >= 0:
            yield self.spans[i][0]
            i = self.spans[i][3]


def launch_times(run) -> list:
    """Per kernel of ``run.kernels`` the host start of the call that
    launched it, or None where its kind could not be paired."""
    calls: dict = {kind: [] for kind in CALLS}
    for name, s, _ in run.cpu:
        kind = _host_kind(name)
        if kind is not None:
            calls[kind].append(s)
    events: dict = {kind: [] for kind in CALLS}
    for i, (name, s, _) in enumerate(run.kernels):
        events[_device_kind(name)].append((s, i))
    out = [None] * len(run.kernels)
    for kind, evs in events.items():
        evs.sort()
        starts = sorted(calls[kind])
        if len(starts) != len(evs):
            continue
        for (_, i), c in zip(evs, starts):
            out[i] = c
    return out


def nest(run) -> list:
    """The ``pe.`` spans of ``run.cpu`` with their parents, by nesting on
    the host's timeline."""
    spans, stack = [], []
    for name, s, e in run.cpu:
        if not name.startswith(PREFIX):
            continue
        while stack and spans[stack[-1]][2] < s:
            stack.pop()
        spans.append((name, s, e, stack[-1] if stack else -1))
        stack.append(len(spans) - 1)
    return spans


def of(run) -> Spans:
    """The run's spans and each kernel's owner, worked out once a run."""
    cached = run.__dict__.get("_pe_spans")
    if cached is not None:
        return cached
    spans = nest(run)
    starts = [s for _, s, _, _ in spans]

    def owner(t):
        if t is None:
            return -1
        # the last span opened by t, else the nearest of its parents still open
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][2] < t:
            i = spans[i][3]
        return i

    launched = launch_times(run)
    out = Spans(spans=spans, launched=launched, owners=[owner(t) for t in launched])
    run.__dict__["_pe_spans"] = out
    return out


def whole_steps(run) -> list:
    """The denoise steps that lie wholly inside the traced window: for each,
    its host start and its kernels as (name, start_us, end_us, in the DiT),
    a kernel taken by the host start of its launch."""
    sp = of(run)
    lo = run.span[0]
    starts = sorted(s for name, s, _, _ in sp.spans if name == STEP and s >= lo)
    if len(starts) < 2:
        return []
    steps = [(s, []) for s in starts[:-1]]
    for kernel, t, o in zip(run.kernels, sp.launched, sp.owners):
        if t is None or not starts[0] <= t < starts[-1]:
            continue
        step = bisect.bisect_right(starts, t) - 1
        steps[step][1].append((*kernel, DIT in sp.chain(o)))
    return steps
