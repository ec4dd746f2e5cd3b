"""The share of the CLI's traced steps (10-14) in which no kernel or copy ran
on the card, in the training cells."""

from kpbench import harness

_i = harness.load_module(harness.BENCH / "metrics" / "_idle.py", "kpbench_metric__idle")


def read(rec: dict):
    return _i.idle(rec, "train")
