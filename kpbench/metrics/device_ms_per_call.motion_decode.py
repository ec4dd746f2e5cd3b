"""Device milliseconds a generate call queued under
``kpvid.generate.motion_decode``: the motion decoder's 2x1024 LSTM over the
32 frames (``MotionGenerator.decode``) (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_device(rec, "motion_decode")
