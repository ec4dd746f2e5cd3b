"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of a kernel call or a whole computation, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
cores, 3.35 TB/s of HBM3. A share of a peak is stated beside the card's
power limit, which the result line's device name does not carry.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, n_bytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of operations over the
    peak rate and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / HBM_BYTES_PER_S)


def conv3x3(x_shape, cout: int, up2: bool, dtype: str = "bfloat16") -> tuple[float, float]:
    """(operations, bytes) of one ``conv3x3_affine`` (``up2``: ``up2_conv3_affine``)
    call on an NHWC input ``x_shape``: 2 * 9 * C * Cout per output pixel; the
    input, the kernel and the output each moved once, and the f32 scale and
    shift."""
    n, h, w, c = x_shape
    oh, ow = (2 * h, 2 * w) if up2 else (h, w)
    size = ITEMSIZE[dtype]
    flops = 2.0 * n * oh * ow * cout * 9 * c
    n_bytes = size * (n * h * w * c + 9 * c * cout + n * oh * ow * cout) + 8 * cout
    return flops, n_bytes
