"""The window's arithmetic takes all the work over all the time: every call
of the offline window over the time from its first launch to its end; every
step between the training window's first and last marks over the time
between them; every request due in the serving window, a failed one slower
than any success."""

from __future__ import annotations

import json

import pytest

from conftest import drive


def test_offline_rate_counts_every_call(smoke):
    clock = iter(range(10_000))

    def patch(harness):
        harness.now = lambda: 0.25 * next(clock)

    result, cell = drive(smoke, "penn-final.offline-b32", seconds=2.0, patch=patch)
    b, t = cell.workload["batch"], cell.model["n_future_frames"]
    # the clock reads 0 for set-up and 0.25 at the window's start; it is read
    # before each call (0.5 ... 2.0: 7 calls before the 2.25 s deadline, which
    # the eighth read meets) and once after the card finished (2.5)
    assert result["attempted"] == 7
    assert result["metrics"]["frames_per_s"]["value"] == pytest.approx(7 * b * t / 2.25)


def test_training_window_marks(tmp_path):
    from kpbench import harness

    drv = harness.load_module(harness.BENCH / "drivers" / "train_cli.py", "train_cli_w")
    log = tmp_path / "train_metrics.jsonl"
    log.write_text("\n".join(json.dumps({"step": s, "time": 100.0 + 0.1 * s})
                             for s in range(0, 400, 25)) + "\n")

    class Alive:
        def poll(self):
            return None

    first, last = drv.watch(Alive(), log, warmup=50, seconds=20.0, poll=0)
    assert (first["step"], last["step"]) == (50, 250)  # 250 is 20.0 s after 50


def test_serving_tail_counts_failures(smoke):
    # the serving cell is not in BENCHMARK.json (PERF.md §7): its workload
    # file's own listing names request_p95_ms
    result, cell = drive(smoke, "penn-final.serve-open", seconds=2.0)
    res = json.loads((cell.work / "client" / "results.json").read_text())
    assert result["attempted"] == len(res) == round(cell.workload["traffic"]["rate"] * 2.0)
    lat = sorted((r["done"] - r["due"]) * 1e3 for r in res)
    assert result["metrics"]["request_p95_ms"]["value"] == pytest.approx(lat[-1])  # 16: rank 16
