"""The trace readers on a recorded fixture (data/trace_fixture.pt.trace.json,
the Chrome form of ``torch.profiler``): the device intervals' union and its
gaps, the op that launched each kernel, the roofline shares and the idle
share by hand."""

from __future__ import annotations

from pathlib import Path

import pytest

from kpbench import harness
from kpbench.counts import bound_s, conv3x3

FIXTURE = Path(__file__).parent / "data" / "trace_fixture.pt.trace.json"


def metric(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


@pytest.fixture
def rec():
    rec = harness.chrome_records(FIXTURE)
    lo, hi = next((o[0], o[1]) for o in rec["host"] if o[2] == "kpbench.window")
    busy, _ = harness.busy_and_gaps(rec["device"], lo, hi)
    rec.update(kind="offline", window=(lo, hi), calls=1, busy_s=busy, window_s=(hi - lo) / 1e9,
               flops_per_call=1e12, wall_per_call_s=0.01)
    return rec


def test_union_and_gaps(rec):
    assert rec["busy_s"] == pytest.approx(750e-6)  # 500 + 200 + 50 us, no overlap
    busy, gaps = harness.busy_and_gaps(rec["device"], *rec["window"])
    assert [((a - 1_000_000) / 1e3, (b - 1_000_000) / 1e3) for a, b in gaps] == [
        (0.0, 30.0), (530.0, 600.0), (800.0, 900.0), (950.0, 1000.0)]
    overlap = [(0, 10, "a", 1), (5, 20, "b", 2)]
    assert harness.busy_and_gaps(overlap, 0, 30)[0] == pytest.approx(20e-9)


def test_readers(rec):
    one = bound_s(*conv3x3((128, 32, 32, 256), 256, False))
    two = bound_s(*conv3x3((128, 32, 32, 256), 128, True))
    assert metric("conv3x3_affine_roofline").read(rec) == pytest.approx(100 * one / 500e-6)
    assert metric("up2_conv3_affine_roofline").read(rec) == pytest.approx(100 * two / 200e-6)
    assert metric("idle_pct.offline").read(rec) == pytest.approx(25.0)
    assert metric("idle_pct.train").read(rec) is None  # another cell's kind: nothing to read
    assert metric("device_ms_per_call.generate").read(rec) == pytest.approx(0.75)
    assert metric("mfu_pct.generate").read(rec) == pytest.approx(100 * 1e14 / 989e12)


def test_launch_links_and_breakdown(rec):
    ops, device_s = harness.launched_under(rec, "kpvid::conv3x3_affine")
    assert len(ops) == 1 and device_s == pytest.approx(500e-6)
    assert harness.launched_under(rec, "aten::copy_")[1] == pytest.approx(50e-6)
    b = harness.breakdown(rec, *rec["window"])
    assert b["device_ops"][0] == ["conv3x3_mma_kernel", pytest.approx(500e-6)]
    idle = dict(b["idle_gaps"])
    assert idle["kpvid::conv3x3_affine"] == pytest.approx(30e-6)
    assert idle["aten::copy_"] == pytest.approx(100e-6)
