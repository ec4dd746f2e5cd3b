"""Milliseconds a generate call in which the card was idle while the host was
inside ``kpvid.generate.motion_decode``: the host's launches of the motion
decoder's LSTM steps (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_idle(rec, "motion_decode")
