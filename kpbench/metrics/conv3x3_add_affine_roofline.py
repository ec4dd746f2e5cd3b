"""#1+ ``kpvid::conv3x3_add_affine``'s share of its roofline: the sum over its
traced calls of the least time each could take, over the device time of
everything each call launched. A call's operations and bytes are #1's from
its argument shapes (``kpbench.counts.conv3x3``: x, the kernel, the output,
scale and shift) plus its f32 addend (the third argument) read once. A tree
without the op has no such call: nothing to read."""

from kpbench import harness
from kpbench.counts import bound_s, conv3x3

OP = "kpvid::conv3x3_add_affine"


def read(rec: dict):
    if "device" not in rec:
        return None
    ops, device_s = harness.launched_under(rec, OP)
    if not ops or device_s <= 0:
        return None
    least = 0.0
    for *_, shapes, dtypes, _ in ops:
        dtype = "float32" if dtypes and dtypes[0] == "float" else "bfloat16"
        flops, n_bytes = conv3x3(shapes[0], shapes[1][3], False, dtype)
        rows, h, w, cout = shapes[2]
        least += bound_s(flops, n_bytes + 4.0 * rows * h * w * cout, dtype)
    return 100.0 * least / device_s
