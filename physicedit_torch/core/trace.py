"""Program spans for ``torch.profiler``.

``span(name)`` marks a stretch of the port's host code as a profiler range
while a profiler records, so the range lands in the profiler's own trace on
the clock of its device events; otherwise it returns one shared null
context.  With no profiler running the check costs less than opening the
range would, and the DiT opens ~370 spans a step.

The range is the profiler's ``_RecordFunctionFast``, the one ``torch``'s own
compiled code opens around its kernels: a host op like any ATen op, and
some twenty times cheaper to open than a ``record_function``.  A
``record_function`` range would be a user annotation instead, of which the
profiler also makes a device-side copy over the kernels launched inside it;
such copies would stand among the device's kernels in a trace and be read
as launches and busy time.

The names are ``pe.<layer>[.<part>]``; a device kernel belongs to the
innermost ``pe.`` span open on the host when it was launched.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared no-op context."""
    return _range(name) if _recording() else _NULL
