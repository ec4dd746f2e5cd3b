"""``lstm_cell_pct.motion_decode`` on hand-built profiler records: the calls
of test_kpbench_spans.py with the motion decode's products replaced by the
64 ``lstm_cell`` kernels of a 2-layer, 32-step decode, launched by the
decode's ops (eager) or by its graph's launch (replayed). 64 a call reads
100, fewer reads their share; a kernel of that name queued under another
phase, or outside the window, does not count; a decode without the kernel
reads 0, a program without the op and a record without spans None. The
steps a call are read from the listed cell's configuration, and cells whose
configurations decode different numbers of steps read None."""

from __future__ import annotations

import json
import shutil

import pytest

from kpbench import harness
from test_kpbench_spans import Event, one_call, read, record

NAME = "lstm_cell_pct.motion_decode"
WINDOW = [Event("kpbench.window", -10, 990, user=True),
          Event("kpbench.window", -10, 990, device=True)]


def decode_call(at: int, cid: int, kernels: int = 64, replayed: bool = True) -> list:
    """test_kpbench_spans.one_call whose motion decode launches ``kernels``
    lstm_cell kernels: from one graph launch inside the replay's range, or
    each from its own ``kpvid::lstm_cell`` op."""
    out = [e for e in one_call(at, cid) if e.name() not in ("aten::mm", "sgemm")]
    if replayed:
        out += [Event("kpvid.graph.motion_decode", at + 44, at + 49, cid=cid + 50),
                Event("cudaGraphLaunch", at + 46, at + 48, cid=cid + 50)]
    for i in range(kernels):
        link = cid + 50 if replayed else cid + 50 + i
        if not replayed:
            out.append(Event("kpvid::lstm_cell", at + 41 + i, at + 41.5 + i, cid=link))
        out.append(Event("void_lstm_cell_kernel_2__true_", at + 50 + i, at + 50.5 + i,
                         device=True, link=link))
    return out


@pytest.mark.parametrize("replayed", [True, False])
def test_64_kernels_a_call_read_100(replayed):
    rec = record(WINDOW + decode_call(0, 100, replayed=replayed)
                 + decode_call(400, 300, replayed=replayed))
    assert read(NAME, rec) == pytest.approx(100.0)


def test_fewer_kernels_read_their_share():
    rec = record(WINDOW + decode_call(0, 100) + decode_call(400, 300, kernels=32))
    assert read(NAME, rec) == pytest.approx(75.0)


def test_kernels_of_other_phases_or_outside_the_window_do_not_count():
    stray = [Event("kpvid::lstm_cell", 145, 146, cid=90),  # queued under first_conv
             Event("lstm_cell_kernel", 150, 151, device=True, link=90),
             Event("kpvid::lstm_cell", -100, -99, cid=91),  # before the window
             Event("lstm_cell_kernel", -60, -50, device=True, link=91)]
    rec = record(WINDOW + decode_call(0, 100) + decode_call(400, 300) + stray)
    assert read(NAME, rec) == pytest.approx(100.0)


def test_a_decode_without_the_kernel_reads_0(monkeypatch):
    rec = record(WINDOW + one_call(0, 100) + one_call(400, 200))
    assert read(NAME, rec) == 0.0
    import kpvid_tpu_torch.ops

    monkeypatch.delattr(kpvid_tpu_torch.ops, "lstm_cell")  # a program without the op
    assert read(NAME, rec) is None


def test_no_spans_read_none():
    assert read(NAME, {}) is None
    assert read(NAME, {"kind": "train", "busy_s": 1.0, "window_s": 2.0}) is None


def _reader(root=harness.BENCH):
    return harness.load_module(root / "metrics" / f"{NAME}.py", "m_lstm_cell_steps")


def test_the_steps_a_call_are_the_listed_configs():
    model = harness.load_json(harness.BENCH / "configs" / "penn-final.json")["model"]
    assert _reader().steps_a_call() == len(model["cell_info"]) * model["n_future_frames"] == 64


def test_cells_of_other_depths_read_none(tmp_path):
    """A copy of the benchmark whose metric lists a second cell, of a
    configuration with three layers: no one count of steps a call, so the
    share reads None."""
    root = tmp_path / "kpbench"
    for sub in ("metrics", "workloads", "configs"):
        shutil.copytree(harness.BENCH / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"] = m["workloads"] + ["deep.offline"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "workloads" / "deep.offline.json").write_text(json.dumps({"config": "deep"}))
    (root / "configs" / "deep.json").write_text(json.dumps(
        {"model": {"cell_info": [1024] * 3, "n_future_frames": 32}}))
    reader = _reader(root)
    assert reader.steps_a_call() is None
    assert reader.read(record(WINDOW + decode_call(0, 100) + decode_call(400, 300))) is None
