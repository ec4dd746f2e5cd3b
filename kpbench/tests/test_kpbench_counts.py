"""The yardstick's counts: a conv call's operations and bytes by hand, #1's
and #2's bounds a generate at batch 4 as the port's kernel table gives them
(1.1041 and 0.6254 ms), and the model counts against hand counts of the
products they are made of."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import SMOKE_MODEL
from kpbench.counts import bound_s, conv3x3
from kpbench.counts import model as counts
from kpbench.reference import nets

FULL = dict(n_pts=40, n_action=9, cell_info=[1024, 1024], vae_dim=64, image_size=128,
            n_future_frames=32, heatmap_inv_std=14.3, heatmap_size=32, encoder_filters=32,
            translator_filters=256, pose_decoder_filters=128, discriminator_filters=64)


def test_conv_call_by_hand():
    flops, n_bytes = conv3x3((2, 4, 4, 8), 16, up2=False)
    assert flops == 2 * 2 * 4 * 4 * 16 * 9 * 8
    assert n_bytes == 2 * (2 * 4 * 4 * 8 + 9 * 8 * 16 + 2 * 4 * 4 * 16) + 8 * 16
    flops, n_bytes = conv3x3((1, 4, 4, 8), 16, up2=True, dtype="float32")
    assert flops == 2 * 1 * 8 * 8 * 16 * 9 * 8
    assert n_bytes == 4 * (4 * 4 * 8 + 9 * 8 * 16 + 8 * 8 * 16) + 8 * 16


def test_translator_bounds_match_the_kernel_table():
    n = 4 * 32  # frames of a batch-4 generate
    one = [((n, 32, 32, 256), 256, False)] * 3 + [((n, 64, 64, 128), 128, False)] * 3 + [
        ((n, 128, 128, 64), 64, False), ((n, 128, 128, 64), 4, False)]
    two = [((n, 32, 32, 256), 128, True), ((n, 64, 64, 128), 64, True)]
    for calls, table_ms in ((one, 1.1041), (two, 0.6254)):
        flops = sum(conv3x3(*c)[0] for c in calls)
        n_bytes = sum(conv3x3(*c)[1] for c in calls)
        assert 1e3 * bound_s(flops, n_bytes) == pytest.approx(table_ms, abs=6e-4)


def test_counter_counts_products_by_hand():
    P = {"c.weight": torch.empty(16, 8, 3, 3, device="meta"),
         "d.weight": torch.empty(32, 5, device="meta"), "d.bias": torch.empty(5, device="meta"),
         "l.lstm_0_kernel": torch.empty(6 + 4, 16, device="meta"),
         "l.lstm_0_bias": torch.empty(16, device="meta")}
    x = torch.empty(2, 6, 6, 8, device="meta")
    with FlopCounterMode(display=False) as fc:
        nets.conv(x, P["c.weight"], stride=1)
        nets.dense(torch.empty(3, 32, device="meta"), P, "d")
        nets.lstm(torch.empty(2, 7, 6, device="meta"), P, "l")
    assert fc.get_total_flops() == (2 * 2 * 6 * 6 * 16 * 9 * 8 + 2 * 3 * 32 * 5
                                    + 7 * 2 * 2 * 10 * 16)


def test_model_counts():
    # the split first conv saves its static channels on T - 1 frames of each sample
    m = dict(FULL)
    naive = counts.generate_flops(m, 1) + 2.0 * 31 * 32 * 32 * 256 * 9 * (128 + 40)
    assert counts.generate_flops(m, 2) == pytest.approx(2 * counts.generate_flops(m, 1))
    assert naive > counts.generate_flops(m, 1)
    # a training step takes its forward and at least as much again backward
    assert counts.stage1_step_flops(SMOKE_MODEL | {"heatmap_inv_std": 14.3, "n_action": 9},
                                    2) > 0
    assert counts.stage2_step_flops(FULL, 16) > 3 * 16 * 32 * 2 * 2 * (1024 + 80) * 4096
