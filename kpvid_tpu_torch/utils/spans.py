"""Named host ranges for ``torch.profiler`` traces of the port.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
is recording (one started by ``torch.profiler.profile`` or any other), so the
range lands in the same kineto trace as the card's kernels, on one clock.
Otherwise it is one shared ``contextlib.nullcontext()``: a bare
``record_function`` costs microseconds a range with no profiler, the check
well under one. Names are ``kpvid.<layer>.<phase>``.

The ranges are host events: ``torch.export`` drops them from its graph, and
one inside a captured CUDA graph records only at capture, not at replay.
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
