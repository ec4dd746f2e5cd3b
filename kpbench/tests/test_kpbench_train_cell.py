"""The stage-2 training cell's own pieces, on the CPU at smoke widths: the
reference's batches, made from the tree alone, are those the CLI was fed,
and its noise, worked out from the seed, the CLI's; a planted fault of
either fails its check; the data wait over a run's window, on a hand-built
record and in a traced run; and a reader for every per-layer metric of the
cell's listing."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from conftest import BENCH, REPO, drive

CELL = "penn-train.stage2-b16"


def with_fault(fault):
    def patch(harness):
        real = harness.Cell.load.__func__

        def load(cls, *a, **k):
            c = real(cls, *a, **k)
            c.notes["fault"] = fault
            return c

        harness.Cell.load = classmethod(load)

    return patch


def driver():
    from kpbench import harness

    return harness.load_module(BENCH / "drivers" / "train_cli.py", "train_cli_cell")


def test_reference_batches_are_the_fed_batches(smoke):
    result, run = drive(smoke, CELL, seconds=1.0)
    assert result["correct"]
    assert run.notes["readings"]["batches"] == 0.0 and run.notes["readings"]["noise"] < 3e-5
    fed = driver().fed_batches(run, run.work / "capture" / "0")
    from kpbench.reference.sequences import first_batches
    from kpbench.traffic.tree import ensure_tree

    tree = ensure_tree(smoke / ".data", run.workload["tree"], run.model["n_pts"])
    own = first_batches(tree, run.seed % 2**31, run.config["training"]["batch_size"],
                        run.workload["capture_steps"], run.model["n_action"])
    assert len(fed) == len(own) == run.workload["capture_steps"]
    for f, o in zip(fed, own):
        assert set(o) == {"keypoints", "real_seq", "action_code"}
        for k, v in o.items():
            assert f[k].dtype == v.dtype and np.array_equal(f[k], v), k


@pytest.mark.parametrize("fault,check", [("no_rotation", "batches"),
                                         ("seed_off_by_one", "batches"),
                                         ("noise_key", "noise")])
def test_an_input_fault_fails_its_check(smoke, fault, check):
    result, run = drive(smoke, CELL, seconds=1.0, patch=with_fault(fault))
    assert not result["correct"]
    assert run.notes["readings"][check] > 100 * run.workload["checks"][check]


def test_fed_numbers():
    rng = np.random.default_rng(0)
    own = [{"keypoints": rng.standard_normal((4, 8, 2)).astype(np.float32),
            "noise": rng.standard_normal((4, 16)).astype(np.float32)} for _ in range(3)]
    assert driver().fed_numbers(own, own) == {"batches": 0.0, "noise": 0.0}
    fed = [dict(o, noise=o["noise"] + np.float32(1e-3)) for o in own]
    assert driver().fed_numbers(fed, own)["noise"] == pytest.approx(1e-3, rel=1e-3)
    short = [dict(o, keypoints=o["keypoints"][:2]) for o in own]
    assert driver().fed_numbers(short, own)["batches"] == math.inf
    assert driver().fed_numbers([{"noise": o["noise"]} for o in own], own)["batches"] == math.inf


def test_reference_noise_is_the_clis():
    """The reference's noise, worked out from the seed, against the CLI's
    own draw of the first steps' keys: equal but for the last bits of JAX's
    f32 inverse error function."""
    from kpbench.reference.streams import stage2_noise
    from kpvid_tpu_torch.train.cli import key_chain, step_noise
    from kpvid_tpu_torch.utils import jax_random

    for seed in (5, 2**31 - 1):
        rng = key_chain(seed, 0, lambda step: False)
        for want in stage2_noise(seed, 3, 16, 64):
            rng, step_rng = jax_random.split(rng)
            got = step_noise(step_rng, 1, 16, 64)[0]
            assert got.dtype == want.dtype and np.abs(got - want).max() < 3e-5


def test_data_wait_reader_on_a_two_step_record(tmp_path):
    from kpbench import harness

    reader = harness.load_module(BENCH / "metrics" / "data_wait_ms_per_step.train.py", "dw")
    waits = tmp_path / "waits.jsonl"
    waits.write_text("".join(json.dumps(w) + "\n" for w in (
        {"split": "train", "step": 0, "data_wait_s": 0.5},
        {"split": "test", "step": 0, "data_wait_s": 0.5},
        {"split": "train", "step": 2, "data_wait_s": 0.507})))
    wait = driver().data_wait(waits, 0, 2)
    assert reader.read({"data_wait": wait}) == pytest.approx(3.5)  # 7 ms over 2 steps
    assert driver().data_wait(waits, 0, 4) is None
    assert reader.read({"data_wait": None}) is None and reader.read({}) is None


def test_a_traced_run_reads_the_data_wait_over_its_window(smoke):
    result, run = drive(smoke, CELL, seconds=1.0, trace=True)
    assert result["correct"]
    assert result["metrics"]["data_wait_ms_per_step.train"]["value"] > 0


def test_the_cells_per_layer_metrics_each_name_a_reader():
    """The cell is kept for later (PERF.md): its workload file carries its
    listing, and each of its per-layer metrics has a reader that reads None
    from an empty record."""
    import time

    from kpbench import harness

    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert CELL not in {w["name"] for w in b["workloads"]}
    cell = harness.Cell.load(CELL, 1, 1.0, True, time.perf_counter())
    mine = cell.metrics("per_layer")
    assert {m["name"] for m in mine} == {"device_ms_per_step.stage2", "mfu_pct.stage2",
                                         "idle_pct.train", "data_wait_ms_per_step.train"}
    for m in mine:
        assert m["moves"] == "train_examples_per_s"
        reader = harness.load_module(BENCH / "metrics" / f"{m['name']}.py", "r_" + m["name"])
        assert callable(reader.read) and reader.read({}) is None
