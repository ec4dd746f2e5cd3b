"""The motion decode as a CUDA graph replay in a hand-built profiler record
(the calls of test_kpbench_spans.py, a call's two LSTM products replaced by
one graph launch): the port opens ``kpvid.graph.motion_decode`` as an op
around the replay, so the profiler links the graph's kernels to it, and with
it nested in ``kpvid.generate.motion_decode`` every phase's device and idle
milliseconds read as the eager call's. ``replay_pct.motion_decode`` counts
the calls that replayed."""

from __future__ import annotations

import pytest

from kpbench import harness
from test_kpbench_spans import DEVICE, IDLE, Event, one_call, read, record

WINDOW = [Event("kpbench.window", -10, 990, user=True),
          Event("kpbench.window", -10, 990, device=True)]


def replayed_call(at: int, cid: int) -> list:
    """test_kpbench_spans.one_call with the motion decode's two products
    replaced by one graph launch inside the replay's range: the launch
    shares the range's id, and both of the graph's intervals are linked to
    it."""
    out = [e for e in one_call(at, cid) if e.name() not in ("aten::mm", "sgemm")]
    return out + [Event("kpvid.graph.motion_decode", at + 44, at + 49, cid=cid + 3),
                  Event("cudaGraphLaunch", at + 46, at + 48, cid=cid + 3),
                  Event("sgemm", at + 50, at + 60, device=True, link=cid + 3),
                  Event("sigmoid", at + 120, at + 130, device=True, link=cid + 3)]


def calls(*replayed: bool) -> list:
    """The window and a call at 0 and at 400 us, each replayed or eager."""
    return WINDOW + [e for i, r in enumerate(replayed)
                     for e in (replayed_call if r else one_call)(400 * i, 100 * (i + 1))]


def test_a_replay_reads_as_the_eager_call():
    eager, rec = record(calls(False, False)), record(calls(True, True))
    for name in DEVICE + IDLE + ["device_ms_per_call.generate"]:
        assert read(name, rec) == pytest.approx(read(name, eager), abs=1e-12), name
    assert read("device_ms_per_call.motion_decode", rec) == pytest.approx(0.020)
    assert read("idle_ms_per_call.motion_decode", rec) == pytest.approx(0.060)
    spans = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "m__spans")
    assert None not in spans.device_ms(rec)  # every interval counted under a phase


@pytest.mark.parametrize("replayed,want", [((True, True), 100.0), ((True, False), 50.0),
                                           ((False, False), 0.0)])
def test_replay_pct_counts_the_calls_that_replayed(replayed, want):
    assert read("replay_pct.motion_decode", record(calls(*replayed))) == pytest.approx(want)


def test_replay_pct_without_a_window_reads_nothing():
    assert read("replay_pct.motion_decode", {}) is None
    assert read("replay_pct.motion_decode", {"kind": "train", "busy_s": 1.0,
                                            "window_s": 2.0}) is None
