"""The reader of ``conv3x3_add_affine_roofline`` on synthetic trace records:
the split first conv's batch-32 call in bf16 (and an f32 one), the bound
from #1's count plus the addend's bytes, over the device time that the op's
calls launched; nothing to read from a tree without the op, or from a run
with no device trace."""

from __future__ import annotations

import pytest

from kpbench import harness
from kpbench.counts import bound_s, conv3x3

NAME = "conv3x3_add_affine_roofline"


def metric():
    return harness.load_module(harness.BENCH / "metrics" / f"{NAME}.py", "m_" + NAME)


X, K, ADD = [1024, 32, 32, 40], [3, 3, 40, 256], [32, 32, 32, 256]


def record(dtype="c10::BFloat16", op="kpvid::conv3x3_add_affine"):
    """Two calls of the op, each launching a kernel (400 and 600 us), beside
    a #1 call and a copy that the reader must not count."""
    shapes = [X, K, ADD, [256], [256], []]
    types = [dtype, dtype, "float", "float", "float", "Scalar"]
    host = [(0, 10_000, op, 1, shapes, types, 11),
            (20_000, 30_000, op, 1, shapes, types, 12),
            (40_000, 50_000, "kpvid::conv3x3_affine", 1, [[1024, 32, 32, 256], [3, 3, 256, 256],
                                                          [256], [256], []], types, 13),
            (60_000, 70_000, "aten::copy_", 1, [], [], 14)]
    device = [(100_000, 500_000, "conv3x3_add_bf16_mma_kernel", 11),
              (600_000, 1_200_000, "conv3x3_add_bf16_mma_kernel", 12),
              (1_300_000, 3_300_000, "conv3x3_bf16_mma_kernel", 13),
              (3_400_000, 3_500_000, "copy", 14)]
    return {"device": device, "host": host}


@pytest.mark.parametrize("dtype,kind", [("c10::BFloat16", "bfloat16"), ("float", "float32")])
def test_share_of_the_roofline(dtype, kind):
    flops, n_bytes = conv3x3(X, 256, False, kind)
    want = 100.0 * 2 * bound_s(flops, n_bytes + 4.0 * 32 * 32 * 32 * 256, kind) / 1000e-6
    assert metric().read(record(dtype)) == pytest.approx(want)
    if kind == "bfloat16":
        # 193.3 GFLOP at 989 TFLOP/s (0.1955 ms) against 654.5 MB at 3.35 TB/s
        # (0.1954 ms): two calls of 0.1955 ms in 1 ms of device time
        assert want == pytest.approx(100.0 * 2 * flops / 989e12 / 1000e-6)


def test_nothing_to_read_without_the_op_or_a_device_trace():
    assert metric().read(record(op="kpvid::conv3x3_affine_other")) is None
    assert metric().read({"host": record()["host"]}) is None
