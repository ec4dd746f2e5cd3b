"""One generate call's device and idle time by phase, from the program's own
ranges (``kpvid_tpu_torch/utils/spans.py``) in the traced window.

A call is a ``kpvid.generate`` range inside the window; its phases are the
``kpvid.generate.<phase>`` ranges. A device interval (kernel, copy or
memset) counts for the phase under which it was *queued*, not the one
during which it ran: the profiler links it to the host op that launched it,
and the phase is the innermost ``kpvid.generate.*`` range on that op's
thread that holds the op's start. An idle gap of the window
(``harness.busy_and_gaps``) counts for the innermost phase range, on any
thread, that holds the gap's midpoint. Both are per call, in ms.

A record with no window or no call (the other drivers, a program without
the ranges) reads None. (A CPU run has calls and no device interval: its
device time under every phase reads 0, as ``device_ms_per_call.generate``
does there.)
"""

from __future__ import annotations

import bisect

from kpbench import harness

CALL = "kpvid.generate"
PHASE = CALL + "."


class _Phases:
    """The phase ranges of the window, by thread, sorted by start."""

    def __init__(self, host: list, lo: int, hi: int):
        self.threads: dict = {}
        for o in sorted(host, key=lambda o: o[0]):
            if o[2].startswith(PHASE) and o[1] > lo and o[0] < hi:
                self.threads.setdefault(o[3], []).append(o)
        self.starts = {t: [o[0] for o in spans] for t, spans in self.threads.items()}

    def at(self, thread, t: int):
        """(start, name) of the innermost phase range on ``thread`` that
        holds time ``t``, or None: the latest started of those holding it."""
        spans = self.threads.get(thread, ())
        for j in range(bisect.bisect_right(self.starts.get(thread, ()), t) - 1, -1, -1):
            if spans[j][1] >= t:
                return spans[j][0], spans[j][2]
        return None

    def anywhere(self, t: int):
        """The name of the innermost phase range on any thread holding ``t``."""
        found = [f for f in (self.at(th, t) for th in self.threads) if f is not None]
        return max(found)[1] if found else None


def _window(rec: dict):
    """(lo, hi, the calls in the window, its phases) or None."""
    if "window" not in rec or "device" not in rec:
        return None
    lo, hi = rec["window"]
    calls = sum(1 for o in rec["host"] if o[2] == CALL and o[0] >= lo and o[1] <= hi)
    if not calls:
        return None
    return lo, hi, calls, _Phases(rec["host"], lo, hi)


def device_ms(rec: dict) -> dict | None:
    """phase -> ms of device time queued under it, per call (the device
    intervals' lengths inside the window; ``None`` keys what was queued
    under no phase)."""
    w = _window(rec)
    if w is None:
        return None
    lo, hi, calls, phases = w
    # the host op of each link id (a runtime call that shares its op's id lies inside the op)
    launch = {o[6]: o for o in rec["host"]}
    out: dict = {}
    for t0, t1, _, link in rec["device"]:
        ns = min(t1, hi) - max(t0, lo)
        if ns <= 0:
            continue
        op = launch.get(link)
        hit = phases.at(op[3], op[0]) if op is not None else None
        name = hit[1][len(PHASE):] if hit else None
        out[name] = out.get(name, 0.0) + ns / 1e6 / calls
    return out


def idle_ms(rec: dict) -> dict | None:
    """phase -> ms of the window's idle gaps whose midpoint falls inside it,
    per call."""
    w = _window(rec)
    if w is None:
        return None
    lo, hi, calls, phases = w
    _, gaps = harness.busy_and_gaps(rec["device"], lo, hi)
    out: dict = {}
    for a, b in gaps:
        name = phases.anywhere((a + b) // 2)
        name = name[len(PHASE):] if name else None
        out[name] = out.get(name, 0.0) + (b - a) / 1e6 / calls
    return out


def read_device(rec: dict, phase: str):
    by = device_ms(rec)
    return None if by is None else by.get(phase, 0.0)


def read_idle(rec: dict, phase: str):
    by = idle_ms(rec)
    return None if by is None else by.get(phase, 0.0)
