"""The control comes out not correct at each cell's own size on the card:
the plain reference in the program's place with its operands in float8
(the precision below the configurations' bf16; for training, its backward's
gradients in float8 too). Marked ``gpu``: it skips without a card. On the
card: ``python -m pytest -p no:cacheprovider kpbench/tests/test_kpbench_control.py``."""

from __future__ import annotations

import json
import time

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(cuda, name):
    from kpbench import harness

    cell = harness.Cell.load(name, 2**31 + 101, 3.0, False, time.perf_counter())
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell.workload['kind']}.py",
                                 "kpbench_driver_control")
    limits = cell.workload["checks"]
    if hasattr(driver, "readings"):
        vals = driver.readings(cell, [cell.seed], ["control"])[0]["checks"]
    else:
        cell.notes["program"] = driver.control
        driver.run(cell)
        vals = cell.notes["readings"]
    assert any(vals[k] > lim for k, lim in limits.items()), vals
