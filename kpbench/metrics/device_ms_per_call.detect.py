"""Device milliseconds a generate call queued under ``kpvid.generate.detect``:
the pose encoder and #3 (``Stage1Generator.detect``) (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_device(rec, "detect")
