"""Named host ranges for ``torch.profiler`` traces of the port.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
is recording (one started by ``torch.profiler.profile`` or any other), so the
range lands in the same kineto trace as the card's kernels, on one clock.
Otherwise it is one shared ``contextlib.nullcontext()``: a bare
``record_function`` costs microseconds a range with no profiler, the check
well under one. Names are ``kpvid.<layer>.<phase>``.

The ranges are host events: ``torch.export`` drops them from its graph, and
one inside a captured CUDA graph records only at capture, not at replay.

``span`` records a user range, which the profiler links no kernel to: a
kernel is linked to the innermost op open on its thread when it was queued.
Inside an aten op that is the op; a CUDA graph's replay is no op, so its
kernels are linked to none unless ``op_span`` opens a range of the op kind
(``RecordScope.FUNCTION``) around it.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the range ``name`` while a profiler is
    on, and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def op_span(name: str):
    """As :func:`span`, the range recorded as an op rather than a user range,
    so that the profiler links the kernels queued inside it (and no deeper
    op) to it: around a CUDA graph's replay."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
