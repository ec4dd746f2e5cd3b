"""A ``kpvid::`` conv op's share of its roofline over the traced window:
the sum over its calls of the least time each could take (operations or
bytes from the call's argument shapes, kpbench/counts) over the device time
of everything each call launched (the runtime calls inside the op, linked
to their kernels by the profiler's correlation ids)."""

from kpbench import harness
from kpbench.counts import bound_s, conv3x3


def share(rec: dict, op: str, up2: bool):
    if "device" not in rec:
        return None
    ops, device_s = harness.launched_under(rec, op)
    if not ops or device_s <= 0:
        return None
    least = 0.0
    for *_, shapes, dtypes, _ in ops:
        dtype = "float32" if dtypes and dtypes[0] == "float" else "bfloat16"
        flops, n_bytes = conv3x3(shapes[0], shapes[1][3], up2, dtype)
        least += bound_s(flops, n_bytes, dtype)
    return 100.0 * least / device_s
