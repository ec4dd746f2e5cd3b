"""Device milliseconds a generate call queued under ``kpvid.generate.blend``:
the frames' blend with the source image, and the clamps (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_device(rec, "blend")
