"""The share of the traced window in which no kernel or copy ran on the
card (the union of the device intervals), in the offline cells."""

from kpbench import harness

_i = harness.load_module(harness.BENCH / "metrics" / "_idle.py", "kpbench_metric__idle")


def read(rec: dict):
    return _i.idle(rec, "offline")
