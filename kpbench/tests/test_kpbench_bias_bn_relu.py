"""The reader of ``bias_bn_relu_roofline`` on synthetic trace records: two of
the batch-32 generate's calls in bf16 (and f32 ones), the bound from the
bytes each call moves over the device time that the op's calls launched;
nothing to read from a tree without the op, or from a run with no device
trace."""

from __future__ import annotations

import pytest

from kpbench import harness

NAME = "bias_bn_relu_roofline"


def metric():
    return harness.load_module(harness.BENCH / "metrics" / f"{NAME}.py", "m_" + NAME)


IN0, DEC0 = [32, 128, 128, 32], [32, 16, 16, 128]


def record(dtype="c10::BFloat16", op="kpvid::bias_bn_relu"):
    """Two calls of the op (the image trunk's in0 and the pose decoder's
    dec0a), each launching a kernel (30 and 10 us), beside a cuDNN conv under
    its own op and a copy that the reader must not count."""
    types = [dtype, dtype, "float", "float", "float", "Scalar"]
    host = [(0, 10_000, op, 1, [IN0, [32], [32], [32], [32], []], types, 11),
            (20_000, 30_000, op, 1, [DEC0, [128], [128], [128], [128], []], types, 12),
            (40_000, 50_000, "aten::cudnn_convolution", 1, [[32, 3, 128, 128]], types, 13),
            (60_000, 70_000, "aten::copy_", 1, [], [], 14)]
    device = [(100_000, 130_000, "bias_bn_relu_vec_kernel", 11),
              (140_000, 150_000, "bias_bn_relu_vec_kernel", 12),
              (200_000, 400_000, "cudnn_conv", 13),
              (500_000, 600_000, "copy", 14)]
    return {"device": device, "host": host}


@pytest.mark.parametrize("dtype,size", [("c10::BFloat16", 2), ("float", 4)])
def test_share_of_the_roofline(dtype, size):
    n_bytes = (size * (2 * 32 * 128 * 128 * 32 + 32) + 12 * 32
               + size * (2 * 32 * 16 * 16 * 128 + 128) + 12 * 128)
    want = 100.0 * n_bytes / 3.35e12 / 40e-6
    assert metric().read(record(dtype)) == pytest.approx(want)
    if size == 2:
        # 71.3 MB at 3.35 TB/s is 21.3 us of the 40 us the two calls took
        assert want == pytest.approx(53.2, abs=0.1)


def test_nothing_to_read_without_the_op_or_a_device_trace():
    assert metric().read(record(op="kpvid::bias_bn_relu_other")) is None
    assert metric().read({"host": record()["host"]}) is None
