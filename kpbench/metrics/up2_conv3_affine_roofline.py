"""#2 ``kpvid::up2_conv3_affine``'s share of its roofline (metrics/_roofline.py)."""

from kpbench import harness

_r = harness.load_module(harness.BENCH / "metrics" / "_roofline.py", "kpbench_metric__roofline")


def read(rec: dict):
    return _r.share(rec, "kpvid::up2_conv3_affine", True)
