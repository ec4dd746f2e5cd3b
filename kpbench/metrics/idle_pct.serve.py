"""The share of the traced part of the serving window in which no kernel or
copy ran on the card."""

from kpbench import harness

_i = harness.load_module(harness.BENCH / "metrics" / "_idle.py", "kpbench_metric__idle")


def read(rec: dict):
    return _i.idle(rec, "serve")
