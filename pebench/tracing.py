"""The traced run: ``torch.profiler`` over a run of steps inside the window
(the traffic file's ``traced_steps``), reduced to what the per-layer
metrics and the ledger's breakdown read.  Every metric of a traced run is
a rate per step or a share, so a sample of the window's steps serves, and
the profiler's parse of a whole window's events (some 300,000 kernels)
would not fit a run's time.

- ``kernels``: every device event but CUPTI's "Command Buffer Full" (a
  host stall, not device work) and the benchmark's own spans, as (name,
  start_us, end_us).
- ``busy_s``: the union of their intervals.
- ``breakdown``: the ten device ops that took most time, and the ten
  labels under which the device sat idle longest, a gap labelled by the
  innermost host event running at its middle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "pebench."
WINDOW_SPAN = "pebench.window"
LONGEST_GAPS = 400


@dataclass
class TraceRun:
    """What a per-layer metric reads: the device events, the window, the
    work done in it and the shapes of one step."""
    kernels: list
    window_s: float
    steps: int
    shapes: dict
    busy_s: float = 0.0
    cpu: list = field(default_factory=list)
    span: tuple = (0.0, 0.0)

    def device_s(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(e - s for name, s, e in self.kernels
                   if any(p in name for p in patterns)) / 1e6

    def launches(self) -> int:
        return sum(1 for name, _, _ in self.kernels
                   if not name.startswith(("Memcpy", "Memset")))


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals)) / 1e6


class Tracer:
    """A profiler over part of the window: ``begin`` and ``end`` are called
    at step boundaries (each after a synchronise, so ``window_s`` is the
    traced steps' time); ``span(name)`` marks the benchmark's own calls into
    the program on the host's timeline."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None
        self.steps = 0

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(name)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def begin(self) -> None:
        self._sync()
        self.prof.start()
        self._span = self.span(WINDOW_SPAN)
        self._span.__enter__()
        self.t0 = time.perf_counter()

    def end(self, steps: int) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.steps = steps

    @property
    def open(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def run(self, shapes: dict) -> TraceRun:
        kernels, cpu, span = [], [], None
        for ev in self.prof.events():
            s, e = ev.time_range.start, ev.time_range.end
            if ev.name.startswith(SPAN_PREFIX):
                if ev.name == WINDOW_SPAN and ev.device_type != torch.autograd.DeviceType.CUDA:
                    span = (s, e)
                elif ev.device_type != torch.autograd.DeviceType.CUDA:
                    cpu.append((ev.name, s, e))
            elif ev.device_type == torch.autograd.DeviceType.CUDA:
                if ev.name != "Command Buffer Full":
                    kernels.append((ev.name, s, e))
            else:
                cpu.append((ev.name, s, e))
        if span is None:
            span = (min((s for _, s, _ in kernels), default=0.0),
                    max((e for _, _, e in kernels), default=0.0))
        cpu.sort(key=lambda x: x[1])
        return TraceRun(kernels=kernels, window_s=self.t1 - self.t0, steps=self.steps,
                        shapes=shapes, busy_s=busy_seconds([(s, e) for _, s, e in kernels]),
                        cpu=cpu, span=span)


def breakdown(run: TraceRun, top: int = 10) -> dict:
    totals: dict = {}
    for name, s, e in run.kernels:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in idle_gaps(run, top)]}


def idle_gaps(run: TraceRun, top: int = 10) -> list:
    """Idle device time by what the host was doing, over the longest gaps."""
    lo, hi = run.span
    busy = _merged([(max(s, lo), min(e, hi)) for _, s, e in run.kernels if e > lo and s < hi])
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [s for _, s, _ in run.cpu]
    labels: dict = {}
    for s, e in gaps[:LONGEST_GAPS]:
        mid = (s + e) / 2
        label = "host: no event"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 5000), -1):
            name, _, end = run.cpu[j]
            if end >= mid:
                label = name
                break
        labels[label] = labels.get(label, 0.0) + (e - s) / 1e6
    return sorted(labels.items(), key=lambda kv: -kv[1])[:top]
