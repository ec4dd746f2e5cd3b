"""The plain reference agrees with the port's plain path at smoke widths on
the CPU, in f32: generation (offline and through the daemon, bytes as
served), and both trainers' first steps through the train CLI."""

from __future__ import annotations

import pytest

from conftest import drive


@pytest.mark.parametrize("cell,bounds", [
    ("penn-final.offline-b32", {"points": 1e-5, "frames": 1e-5, "masks": 1e-5,
                                "frames_mean": 1e-6}),
    ("penn-final.serve-open", {"frames_u8": 1, "frames_u8_mean": 0.01, "masks_u8": 1,
                               "points": 1e-5}),
    ("penn-train.stage1-b16", {"pred": 1e-5, "loss": 1e-5, "grad": 1e-3, "update": 1e-3}),
    ("penn-train.stage2-b16", {"pred": 1e-5, "loss": 1e-5, "grad": 1e-3, "update": 1e-3}),
])
def test_reference_agrees_with_the_port(smoke, cell, bounds):
    result, run = drive(smoke, cell, seconds=2.0)
    assert result["correct"] and result["failed"] == 0
    for name, bound in bounds.items():
        assert run.notes["readings"][name] <= bound, name
