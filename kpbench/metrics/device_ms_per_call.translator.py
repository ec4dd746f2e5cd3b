"""Device milliseconds a generate call queued under
``kpvid.generate.translator``: the heads' folding and the translator decode
(8 x #1, 2 x #2) (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_device(rec, "translator")
