"""Device milliseconds a generate call queued under
``kpvid.generate.first_conv``: the image encoder, #4 twice, the split first
conv's two cuDNN convs and their sum (metrics/_spans.py)."""

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")


def read(rec: dict):
    return _s.read_device(rec, "first_conv")
