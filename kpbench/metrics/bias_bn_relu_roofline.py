"""``kpvid::bias_bn_relu``'s share of its roofline: the sum over its traced
calls of the least time each could take, over the device time of everything
each call launched. The op is bytes-bound (a handful of flops an element): a
call moves its activation (the first argument) read once and written once at
its dtype's size, the conv bias read once at that size and the three f32
[C] vectors (mean, mul, beta) read once, all from the call's argument shapes.
A tree without the op has no such call: nothing to read."""

import math

from kpbench import harness
from kpbench.counts import ITEMSIZE, bound_s

OP = "kpvid::bias_bn_relu"


def call_bytes(shape, dtype: str) -> float:
    """Bytes one call moves on an activation of ``shape`` [..., C] in ``dtype``."""
    c = shape[-1]
    return ITEMSIZE[dtype] * (2.0 * math.prod(shape) + c) + 12.0 * c


def read(rec: dict):
    if "device" not in rec:
        return None
    ops, device_s = harness.launched_under(rec, OP)
    if not ops or device_s <= 0:
        return None
    least = 0.0
    for *_, shapes, dtypes, _ in ops:
        dtype = "float32" if dtypes and dtypes[0] == "float" else "bfloat16"
        least += bound_s(0.0, call_bytes(shapes[0], dtype), dtype)
    return 100.0 * least / device_s
