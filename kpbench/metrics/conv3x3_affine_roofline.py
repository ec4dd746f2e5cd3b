"""#1 ``kpvid::conv3x3_affine``'s share of its roofline (metrics/_roofline.py)."""

from kpbench import harness

_r = harness.load_module(harness.BENCH / "metrics" / "_roofline.py", "kpbench_metric__roofline")


def read(rec: dict):
    return _r.share(rec, "kpvid::conv3x3_affine", False)
