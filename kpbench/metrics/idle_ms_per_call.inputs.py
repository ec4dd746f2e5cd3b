"""Milliseconds a generate call in which the card was idle while the host was
inside ``kpvid.generate.inputs``: the host's staging and queueing of the
image, action and latent copies (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_idle(rec, "inputs")
