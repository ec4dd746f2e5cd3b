"""The phase readers (metrics/_spans.py: ``device_ms_per_call.<phase>``,
``idle_ms_per_call.<phase>``) on a hand-built profiler record of two generate
calls, reduced by ``harness.trace_records`` as a traced run reduces its
profiler, where each reading is known exactly: a kernel queued under
``translator`` that runs during ``blend`` counts for ``translator``; the
device-side mirrors of the ranges, which the harness drops, count nowhere; an
idle gap whose midpoint lies inside ``motion_decode``, under a nested
``aten::mm``, counts for ``motion_decode``. A record without the program's
ranges reads None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.profiler import DeviceType

from kpbench import harness

US = 1000  # ns
DEVICE = ["device_ms_per_call." + p for p in
          ("detect", "motion_decode", "first_conv", "translator", "blend")]
IDLE = ["idle_ms_per_call.inputs", "idle_ms_per_call.motion_decode"]


class Event:
    """The part of a kineto event that ``harness.trace_records`` reads."""

    def __init__(self, name, t0, t1, device=False, link=0, cid=0, user=False):
        self._v = (name, t0 * US, t1 * US, device, link, cid, user)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def linked_correlation_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def start_thread_id(self):
        return 1

    def shapes(self):
        return []

    def dtypes(self):
        return []


def one_call(at: int, cid: int) -> list:
    """A generate call at ``at`` us whose host ops have ids from ``cid``:
    (phase range, op in it, the device interval that op queued)."""
    def r(name, t0, t1):
        return Event("kpvid.generate" + name, at + t0, at + t1, user=True)

    def op(name, t0, t1, k):
        return Event(name, at + t0, at + t1, cid=cid + k)

    def run(name, t0, t1, k):
        return Event(name, at + t0, at + t1, device=True, link=cid + k)

    return [
        r("", 0, 290),
        r(".inputs", 0, 20), op("aten::copy_", 2, 10, 1), run("Memcpy HtoD", 10, 20, 1),
        r(".detect", 20, 40), op("aten::convolution", 22, 30, 2), run("conv", 30, 50, 2),
        r(".motion_decode", 40, 138), op("aten::mm", 45, 50, 3), run("sgemm", 50, 60, 3),
        op("aten::mm", 80, 130, 4), run("sgemm", 120, 130, 4),  # the gap [60, 120] lies under it
        r(".first_conv", 142, 160), op("aten::add", 144, 148, 5), run("add", 150, 190, 5),
        r(".translator", 160, 190), op("aten::cat", 162, 165, 6), run("cat", 190, 200, 6),
        r(".translator", 190, 250), op("kpvid::conv3x3_affine", 195, 200, 7),
        op("cudaLaunchKernel", 196, 198, 7),  # the runtime call shares the op's id
        run("conv3x3_mma_kernel", 200, 320, 7),  # runs through blend and past the call
        run("kpvid.generate.translator", 200, 320, 7),  # the range's mirror on the device
        r(".blend", 250, 290), op("aten::mul", 255, 260, 8), run("mul", 320, 330, 8),
    ]


@pytest.fixture
def events():
    return [Event("kpbench.window", -10, 990, user=True),
            Event("kpbench.window", -10, 990, device=True),  # its mirror
            Event("aten::mm", -100, -90, cid=1), Event("sgemm", -60, -20, device=True, link=1),
            *one_call(0, 100), *one_call(400, 200)]


def record(events) -> dict:
    """What the offline driver's ``trace_calls`` makes of a profiler."""
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    rec = harness.trace_records(prof)
    lo, hi = next((o[0], o[1]) for o in rec["host"] if o[2] == "kpbench.window")
    busy, _ = harness.busy_and_gaps(rec["device"], lo, hi)
    rec.update(kind="offline", window=(lo, hi), calls=2, busy_s=busy, window_s=(hi - lo) / 1e9,
               flops_per_call=1e9, wall_per_call_s=1e-3)
    return rec


def read(name, rec):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_")).read(rec)


def test_device_time_counts_for_the_phase_it_was_queued_under(events):
    rec = record(events)
    got = {name.split(".")[1]: read(name, rec) for name in DEVICE}
    # ms a call; translator: 10 us from the heads' range, 120 us of the kernel
    # that runs during blend; the mirrors count nowhere
    assert got == pytest.approx({"detect": 0.020, "motion_decode": 0.020, "first_conv": 0.040,
                                 "translator": 0.130, "blend": 0.010}, abs=1e-12)
    spans = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "m__spans")
    by_phase = spans.device_ms(rec)
    assert by_phase["inputs"] == pytest.approx(0.010)
    assert None not in by_phase  # every interval of the window was queued under a phase
    # the phases and the inputs make up the whole call's device time
    whole = read("device_ms_per_call.generate", rec)
    assert whole == pytest.approx(0.230) and sum(by_phase.values()) == pytest.approx(whole)


def test_idle_gaps_count_for_the_phase_at_their_midpoint(events):
    rec = record(events)
    # the gaps, us: [-10, 10] mid 0, call 1's inputs; [20, 30] its detect;
    # [60, 120] mid 90, its motion_decode under aten::mm; [130, 150] mid 140,
    # between two phases; [330, 410] mid 370, between the calls, so call 2's
    # inputs has none; then call 2 as call 1, and [730, 990] after it
    assert read("idle_ms_per_call.inputs", rec) == pytest.approx(0.010)
    assert read("idle_ms_per_call.motion_decode", rec) == pytest.approx(0.060)
    spans = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "m__spans")
    idle = spans.idle_ms(rec)
    assert idle == pytest.approx({"inputs": 0.010, "detect": 0.010, "motion_decode": 0.060,
                                  None: (20 + 80 + 20 + 260) / 2 / 1e3})
    assert sum(idle.values()) == pytest.approx((rec["window_s"] - rec["busy_s"]) * 1e3 / 2)


def test_a_record_without_the_programs_ranges_reads_nothing(events):
    rec = record([e for e in events if not e.name().startswith("kpvid.")])
    assert [read(name, rec) for name in DEVICE + IDLE] == [None] * 7
    assert read("device_ms_per_call.generate", rec) is not None  # the rest still reads
    for name in DEVICE + IDLE:  # nor another driver's record, or none at all
        assert read(name, {"kind": "train", "busy_s": 1.0, "window_s": 2.0}) is None
        assert read(name, {}) is None
