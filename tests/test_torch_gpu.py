"""Kernels of kpvid_tpu_torch against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor kpvid_tpu, so on a machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: float32 with TF32 off agrees to reassociation (rtol 1e-4,
atol 1e-4); bfloat16 outputs round once in the kernel and twice in the plain
version (conv output, then the affine), so they are held to 2% of the
output's largest magnitude. The keypoints of the soft-argmax are f32 from f32
or bf16 maps (rtol 1e-4, atol 1e-5); Gaussian maps written in bf16 round the
same f32 product once on both sides, so they stay within one bf16 step. The
backward kernels against the plain versions' torch autograd: f32 gradients
within 1e-5 of each tensor's largest magnitude; a bf16 maps' gradient within
one bf16 step of each element or that f32 bound, whichever is larger (both
round an f32 value once, and where the two marginals' terms cancel the f32
values differ by more than one step of their small sum); the points'
gradient from a bf16 cotangent within 1e-4 of its largest magnitude.

The backwards run at stage 1's shapes and at edge shapes (one image or frame
and 33, 30^2, K = 40 and K = 6 for the element-wise path) and give the same
bits twice; the render's backward, a cluster of 8 blocks a frame, refuses a
frame whose blocks it cannot hold rather than run anything else. evaluate's
launch over two replicas returns to the host while a spin kernel runs on the
first replica's stream (it copies no host array to the card).

The generation parameters at Config() width, written as a TF1 bundle under
the reference's names, are read onto the card by the port's bundle reader
to the same bits (and generate the same bits).

Each ``torch.ops.kpvid`` op passes ``torch.library.opcheck`` on CUDA tensors,
and a serving artifact traced on the CPU or on the card runs on the card
through the kernels: 8 / 1 / 2 / 1 / 2 / 28 launches a batch, the live engine's
outputs within one uint8 step and 1e-5 on the points.

The conv shapes cover the main path at N = 2 (Config() widths), ragged
spatial tiles, C not a multiple of the 16-channel stage, Cout not a multiple
of the output-channel tile, ReLU on and off, and C % 8 != 0, which takes the
bf16 kernel's element-wise loader; for the persistent bf16 kernel also fewer
tiles than blocks of a full grid (N = 1), blocks that walk many tiles
(N = 16), a border-heavy shape at C = 40, and two launches that give the
same bytes. #2 also at H or W of 1 and 2 and at 17 x 9, and, in bf16 at
oct1a's and oct2a's shapes, on each border line by that line's own largest
magnitude (the phase form's edge terms). #1+ (conv3x3_add_affine, the split first conv with oct0a's BN
and ReLU) at the batch-32 generate's shape ([1024, 32, 32, 40] -> 256, an
addend row per 32 frames), on ragged borders with one frame a row, at
Cout = 72 and 4 (the 64- and 8-channel tiles), at C = 12 (the element-wise
loader) with Cout = 30 (the addend copied element by element), f32 and
bf16, and twice to the same bytes.

The encoders' inference bias + BN + ReLU (``kpvid::bias_bn_relu``) gives
the bits of the torch passes it replaces (its plain version on the card's
tensors) at each of the 30 layers' batch-32 shapes and at odd sizes (C = 16
at 1 x 1 and N = 1, C not a multiple of the 16-byte vector, C = 40 and 264,
an empty batch, a pointer off a 16-byte boundary, NHWC over NCHW memory),
f32 and bf16, on values that land on bf16 rounding ties, negative values,
signed zeros and NaN; a batch-32 generate at Config() through it launches it
28 times and gives the bits of the module-by-module route with the full
image trunk, as do generates at batch 1 and 3 from HWC views of CHW images.

Generate's motion decode replayed from a CUDA graph (eval/final.py::
GraphedDecode) gives the eager decode's bits at batch 1, 4 and 32 of
Config()'s decoder; a call's result outlives the next replay; parameters
loaded in place show at the next replay and rebound ones force a capture;
two replicas on one card replay their own rows; the daemon without its
warm-up captures at a bucket's first batch, readbacks in flight; under a caller's stream
capture (the graphed stage-2 step too) and under ``torch.export`` the decode
runs eager; under a profiler a graphed shape replays and a new one runs
eager without a capture, and the profiler links the replayed kernels to
the replay's range; the counters read one capture and a replay a call.

The motion decode's LSTM step (``kpvid::lstm_cell``) against its plain
version at the decoder's two layer shapes, B = 1, 4, 20, 32 and 40 (padded
and second batch tiles), at odd shapes (the element-wise loader, units past
H, an empty input) and on strided views, h and c within 1e-5, the same bits
twice; the decoder's LSTM through it over 32 steps against the torch route
within the flax test's bf16 bounds.
"""

import contextlib
import sys
import time
import weakref
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from kpvid_tpu_torch import ops
from kpvid_tpu_torch.configs import Config, load_config
from kpvid_tpu_torch.eval import FinalGenerator, InferenceEngine, MicroBatcher, request_z
from kpvid_tpu_torch.eval.final import GraphedDecode
from kpvid_tpu_torch.ops import (
    bias_bn_relu,
    bias_bn_relu_plain,
    conv3x3_add_affine,
    conv3x3_add_affine_plain,
    conv3x3_affine,
    conv3x3_affine_plain,
    gaussian_render,
    gaussian_render_backward,
    heatmaps_to_keypoints,
    launch_counts,
    lstm_cell,
    lstm_cell_plain,
    pose_head,
    pose_head_backward,
    render_gaussian_maps,
    reset_launch_counts,
    up2_conv3_affine,
    up2_conv3_affine_plain,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import host_arrays, multi_fns, replay_kernels, restore_in_place  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert (got - want).abs().max() <= 0.02 * want.abs().max()


def _conv_inputs(dev, dtype, n, h, w, c, cout, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g)
    k = torch.randn(3, 3, c, cout, generator=g) / (3 * c**0.5)
    scale = torch.rand(cout, generator=g) + 0.5
    shift = torch.randn(cout, generator=g) * 0.1
    return x.to(dev, dtype), k.to(dev, dtype), scale.to(dev), shift.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,relu",
    [((2, 16, 16, 64, 64), True), ((3, 20, 12, 24, 72), True), ((2, 32, 32, 64, 4), False),
     # the main path's shapes at N = 2: oct0, oct1, oct2b, the fused heads
     ((2, 32, 32, 256, 256), True), ((2, 64, 64, 128, 128), True),
     ((2, 128, 128, 64, 64), True), ((2, 128, 128, 64, 4), False),
     # ragged tiles, C = 40, Cout = 8, ReLU off; C = 4 and 12 (element-wise loader)
     ((2, 7, 5, 32, 64), True), ((2, 16, 16, 40, 64), False), ((2, 16, 16, 64, 8), True),
     ((2, 16, 16, 4, 16), True), ((2, 12, 20, 12, 64), False), ((1, 9, 9, 4, 4), False),
     # fewer tiles than SMs; many tiles a block; C = 40 (not a multiple of the
     # 16-channel stage) on ragged borders; oct0 at N = 3
     ((1, 32, 32, 256, 256), True), ((16, 64, 64, 128, 128), True),
     ((3, 37, 29, 40, 128), True), ((3, 32, 32, 256, 256), True)],
)
def test_conv3x3_kernel_matches_plain(dev, dtype, shape, relu):
    x, k, s, t = _conv_inputs(dev, dtype, *shape)
    got = conv3x3_affine(x, k, s, t, relu=relu)
    torch.cuda.synchronize()
    _close(got, conv3x3_affine_plain(x, k, s, t, relu=relu), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,relu",
    [((2, 8, 8, 32, 64), True), ((2, 7, 5, 16, 8), True),
     # the main path's shapes at N = 2: oct1a, oct2a
     ((2, 32, 32, 256, 128), True), ((2, 64, 64, 128, 64), True),
     # ragged, C = 24, Cout = 72, ReLU off; C = 4 and 12 (element-wise loader)
     ((2, 10, 6, 24, 72), False), ((2, 8, 8, 4, 16), True), ((2, 5, 7, 12, 8), False),
     # many tiles a block: oct1a and oct2a at N = 16; C = 40 on ragged borders
     ((16, 32, 32, 256, 128), True), ((16, 64, 64, 128, 64), True),
     ((3, 19, 13, 40, 128), True),
     # H or W of 1 and 2 (every border line in one tile, lines that coincide);
     # 17 x 9 (a partial tile at the top and the left); the element-wise
     # loader at W = 2 and on partial tiles
     ((2, 1, 1, 32, 64), True), ((2, 1, 5, 16, 72), False), ((2, 2, 3, 40, 128), True),
     ((2, 5, 2, 12, 64), True), ((3, 17, 9, 32, 64), True), ((2, 17, 9, 4, 8), False)],
)
def test_up2_kernel_matches_plain(dev, dtype, shape, relu):
    x, k, s, t = _conv_inputs(dev, dtype, *shape, seed=1)
    got = up2_conv3_affine(x, k, s, t, relu=relu)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    _close(got, up2_conv3_affine_plain(x, k, s, t, relu=relu), dtype)


@pytest.mark.parametrize("shape", [(2, 32, 32, 256, 128), (2, 64, 64, 128, 64)])
def test_up2_kernel_border_lines_match_plain(dev, shape):
    """bf16 #2 at oct1a's and oct2a's shapes, each border line (output rows
    and columns 0, 2n - 2, 2n - 1: where the phase form needs its edge
    terms) held to the plain version by 2% of that line's own largest
    magnitude, which a wrong edge term would pass under the whole tensor's."""
    x, k, s, t = _conv_inputs(dev, torch.bfloat16, *shape, seed=5)
    got = up2_conv3_affine(x, k, s, t, relu=False).float().cpu()
    want = up2_conv3_affine_plain(x, k, s, t, relu=False).float().cpu()
    h, w = 2 * shape[1], 2 * shape[2]
    lines = [("row", r, got[:, r], want[:, r]) for r in (0, h - 2, h - 1)]
    lines += [("column", c, got[:, :, c], want[:, :, c]) for c in (0, w - 2, w - 1)]
    for axis, i, g, want_line in lines:
        err, bound = (g - want_line).abs().max(), 0.02 * want_line.abs().max()
        assert err <= bound, f"{axis} {i}: {err} > {bound}"


def _addend(dev, x, cout, frames, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, h, w, _ = x.shape
    return torch.randn(n // frames, h, w, cout, generator=g).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,frames,relu",
    [  # the batch-32 generate's split first conv: 1,024 frames, 32 a sample
     ((1024, 32, 32, 40, 256), 32, True),
     # ragged borders, one frame a row; Cout 72 and 4 (the 64- and 8-channel
     # tiles), ReLU off; C = 12 (element-wise loader) with Cout = 30 (the
     # addend's element-wise copies)
     ((3, 37, 29, 40, 128), 1, True), ((4, 20, 12, 24, 72), 2, False),
     ((4, 16, 16, 64, 4), 4, False), ((2, 12, 20, 12, 30), 2, True)],
)
def test_conv3x3_add_kernel_matches_plain(dev, dtype, shape, frames, relu):
    x, k, s, t = _conv_inputs(dev, dtype, *shape, seed=2)
    add = _addend(dev, x, shape[4], frames)
    got = conv3x3_add_affine(x, k, add, s, t, relu=relu)
    torch.cuda.synchronize()
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == dtype
    _close(got, conv3x3_add_affine_plain(x, k, add, s, t, relu=relu), dtype)


def test_conv3x3_add_kernel_gives_the_same_bytes_twice(dev):
    # the batch-32 split first conv, bf16
    x, k, s, t = _conv_inputs(dev, torch.bfloat16, 1024, 32, 32, 40, 256, seed=4)
    add = _addend(dev, x, 256, 32, seed=4)
    first = conv3x3_add_affine(x, k, add, s, t, relu=True)
    second = conv3x3_add_affine(x, k, add, s, t, relu=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("up2", [False, True])
def test_conv_kernels_give_the_same_bytes_twice(dev, up2):
    # oct1 b/c/d and oct2a at N = 4, bf16: no launch depends on another's timing
    shape = (4, 64, 64, 128, 64 if up2 else 128)
    x, k, s, t = _conv_inputs(dev, torch.bfloat16, *shape, seed=3)
    fn = up2_conv3_affine if up2 else conv3x3_affine
    first = fn(x, k, s, t, relu=True)
    second = fn(x, k, s, t, relu=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_keypoint_kernels_match_plain(dev):
    g = torch.Generator().manual_seed(2)
    raw = torch.randn(3, 32, 24, 40, generator=g).to(dev)
    torch.testing.assert_close(
        pose_head(raw), heatmaps_to_keypoints(raw), rtol=1e-4, atol=1e-5
    )
    mu = (torch.rand(5, 40, 2, generator=g) * 2 - 1).to(dev)
    torch.testing.assert_close(
        gaussian_render(mu, 32, 16), render_gaussian_maps(mu, 32, 16), rtol=1e-4, atol=1e-5
    )
    mu = mu.to(torch.bfloat16).float()
    torch.testing.assert_close(
        gaussian_render(mu, 32, 32, grid_dtype=torch.bfloat16),
        render_gaussian_maps(mu, 32, 32, grid_dtype=torch.bfloat16), rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    # the main path's [4, 128, 128, 40]; the smoke widths; H = 37, which the
    # cluster's 8 bands do not divide; K = 5; W * K * 2 bytes not a multiple
    # of 16 (the element-wise loader); H < 8 (blocks with no rows)
    [(4, 128, 128, 40), (1, 32, 32, 8), (2, 37, 24, 40), (2, 32, 24, 5), (2, 20, 23, 5),
     (3, 5, 16, 8)],
)
def test_pose_head_kernel_matches_plain(dev, dtype, shape):
    g = torch.Generator().manual_seed(3)
    raw = (torch.randn(*shape, generator=g) * 3).to(dev, dtype)
    got = pose_head(raw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[3], 2)
    torch.testing.assert_close(got, heatmaps_to_keypoints(raw), rtol=1e-4, atol=1e-5)


def test_pose_head_same_points_twice(dev):
    """One launch, no atomics: the order of every sum is fixed."""
    g = torch.Generator().manual_seed(4)
    raw = torch.randn(4, 128, 128, 40, generator=g).to(dev, torch.bfloat16)
    assert torch.equal(pose_head(raw), pose_head(raw))


def _within_one_bf16_step(got, want) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0**-7 * torch.maximum(g.abs(), w.abs()) + 2.0**-126).all())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(1, 40), (1024, 40), (1, 5), (1024, 5)])
def test_gaussian_render_kernel_matches_plain(dev, out_dtype, grid_dtype, n, k):
    """f32 maps at rtol 1e-4; bf16 maps within one bf16 step of the plain
    version's f32 product rounded once. K = 5 takes the scalar stores."""
    g = torch.Generator().manual_seed(5)
    mu = (torch.rand(n, k, 2, generator=g) * 2 - 1).to(grid_dtype).float().to(dev)
    got = gaussian_render(mu, 32, 32, 14.3, grid_dtype=grid_dtype, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = render_gaussian_maps(mu, 32, 32, 14.3, grid_dtype=grid_dtype, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (n, 32, 32, k)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert _within_one_bf16_step(got, want)


def _max_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    # stage 1's training shape; the smoke widths; H = 37; K = 5 (scalar stores);
    # one image and 33 (a block's rows across two images) at 30^2, K = 40 and
    # K = 6 (scalar stores)
    [(32, 128, 128, 40), (2, 32, 32, 8), (2, 37, 24, 40), (3, 16, 20, 5), (1, 30, 30, 40),
     (33, 30, 30, 40), (1, 30, 30, 6), (33, 30, 30, 6)],
)
def test_pose_head_backward_kernel_matches_plain(dev, dtype, shape):
    g = torch.Generator().manual_seed(6)
    raw = (torch.randn(*shape, generator=g) * 3).to(dev, dtype)
    ct = torch.randn(shape[0], shape[3], 2, generator=g).to(dev)
    kernel_in = raw.clone().requires_grad_()
    plain_in = raw.clone().requires_grad_()
    reset_launch_counts()
    pts = pose_head(kernel_in)
    (got,) = torch.autograd.grad(pts, kernel_in, ct)
    torch.cuda.synchronize()
    assert launch_counts()["pose_head"] == 1 and launch_counts()["pose_head_backward"] == 1
    (want,) = torch.autograd.grad(heatmaps_to_keypoints(plain_in), plain_in, ct)
    assert got.dtype == dtype and got.shape == raw.shape
    if dtype == torch.float32:
        assert _max_gap(got, want) <= 1e-5
    else:
        g32, w32 = got.float(), want.float()
        step = 2.0**-7 * torch.maximum(g32.abs(), w32.abs())
        assert bool(((g32 - w32).abs() <= torch.clamp(step, min=1e-5 * float(w32.abs().max()))).all())
    torch.testing.assert_close(pts.detach(), heatmaps_to_keypoints(raw), rtol=1e-4, atol=1e-5)
    _, p, q = torch.ops.kpvid.pose_head_train(raw)
    assert torch.equal(pose_head_backward(ct, pts.detach(), p, q, dtype), got)  # the same bits


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,k", [(16, 32, 40), (3, 8, 5), (2, 128, 40), (5, 16, 8),
                                    (1, 30, 40), (33, 30, 40), (1, 30, 6), (33, 30, 6)])
def test_render_backward_kernel_matches_plain(dev, out_dtype, n, hw, k):
    """Stage 1's render at [16, 32^2, 40] (the f32 grid), small and odd K,
    128^2, and one and 33 frames at 30^2 (a short last band) with K = 40 and
    K = 6 (element loads); the maps' cotangent in the maps' dtype."""
    g = torch.Generator().manual_seed(7)
    mu = (torch.rand(n, k, 2, generator=g) * 2 - 1).to(dev)
    ct = torch.randn(n, hw, hw, k, generator=g).to(dev, out_dtype)
    kernel_in, plain_in = mu.clone().requires_grad_(), mu.clone().requires_grad_()
    reset_launch_counts()
    maps = gaussian_render(kernel_in, hw, hw, 14.3, out_dtype=out_dtype)
    (got,) = torch.autograd.grad(maps, kernel_in, ct)
    torch.cuda.synchronize()
    assert launch_counts()["gaussian_render_backward"] == 1
    want_maps = render_gaussian_maps(plain_in, hw, hw, 14.3, out_dtype=out_dtype)
    (want,) = torch.autograd.grad(want_maps, plain_in, ct)
    assert got.dtype == torch.float32 and got.shape == mu.shape
    assert _max_gap(got, want) <= (1e-5 if out_dtype == torch.float32 else 1e-4)
    again = gaussian_render_backward(ct.contiguous(), mu, 14.3)
    assert torch.equal(again, gaussian_render_backward(ct.contiguous(), mu, 14.3))


def test_render_backward_refuses_a_cluster_it_cannot_hold(dev):
    """#4's backward runs as clusters of 8 blocks a frame. Where a block's
    shared memory (the band's exponentials, 2 x ceil(H / 8) x K floats) is
    more than a block of the card can hold, the launch is refused with an
    error, and nothing runs in its place: no launch is counted and no plain
    version answers."""
    ct = torch.zeros(1, 8 * 3700, 1, 8, device=dev, dtype=torch.bfloat16)
    mu = torch.zeros(1, 8, 2, device=dev)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="gaussian_render_backward kernel launch failed"):
        gaussian_render_backward(ct, mu, 14.3)
    torch.cuda.synchronize()
    assert launch_counts()["gaussian_render_backward"] == 0


def test_stage1_step_on_card_launches_and_matches_cpu(dev):
    """One fused stage-1 step at smoke widths, f32 with TF32 off: one #3 and
    two #4 forwards and their three backwards, no conv kernel; losses within
    rtol 1e-4 and every gradient tensor within 5% in relative L2 of the
    CPU's step from the same parameters and batch. Not element by element:
    the step's gradient is not continuous in its inputs (ReLU and leaky ReLU
    kinks, max-pools, the perceptual L1's signs), and forwards that differ
    in the last bit turn some of those terms over (chip_smoke.py measures
    the card against itself with an input one ulp off). Not the biases whose
    gradient is zero in exact arithmetic (a conv's before a train-mode BN,
    the heat map's): each side holds only its own rounding there."""
    import dataclasses

    from kpvid_tpu_torch.configs import ModelConfig, TrainingConfig
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer

    cfg = dataclasses.replace(
        Config(), model=ModelConfig(n_pts=8, image_size=32, heatmap_size=8, encoder_filters=8,
                                    translator_filters=16, pose_decoder_filters=16,
                                    discriminator_filters=8),
        training=TrainingConfig(compute_dtype="float32", batch_size=2)).validate()
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
             for k in ("image", "future_image")}
    vgg = synthesize_vgg19_params(max_width=16)
    out = {}
    for device in (dev, "cpu"):
        t = Stage1Trainer(cfg, vgg, device=device)
        t.load_parameters(t.init_parameters(3))
        reset_launch_counts()
        g_grads, fake, g_m = t.g_grads(*t._pair_of(batch))
        d_grads, d_m = t.d_grads(t._pair_of(batch)[1], fake)
        names = t._g_names + t._d_names
        out[str(device)] = ({k: float(v) for k, v in {**g_m, **d_m}.items()},
                            [g.cpu() for g in list(g_grads) + list(d_grads)], launch_counts())
    (lc, gc, counts), (lp, gp, _) = out[str(dev)], out["cpu"]
    assert counts == {"conv3x3_affine": 0, "conv3x3_add_affine": 0, "up2_conv3_affine": 0,
                      "pose_head": 1, "gaussian_render": 2, "pose_head_backward": 1,
                      "gaussian_render_backward": 2, "bias_bn_relu": 0, "lstm_cell": 0}
    for k in lp:
        assert lc[k] == pytest.approx(lp[k], rel=1e-4), k
    for name, a, b in zip(names, gc, gp):
        if not name.endswith((".conv.bias", "heat.bias")):
            assert float((a - b).norm()) <= 5e-2 * max(float(b.norm()), 1e-30), name


def test_wrappers_count_launches_and_check_inputs(dev):
    reset_launch_counts()
    x, k, s, t = _conv_inputs(dev, torch.float32, 1, 8, 8, 16, 16)
    conv3x3_affine(x, k, s, t)
    conv3x3_add_affine(x, k, torch.zeros(1, 8, 8, 16, device=dev), s, t)
    up2_conv3_affine(x, k, s, t)
    pose_head(torch.zeros(1, 8, 8, 4, device=dev))
    gaussian_render(torch.zeros(1, 4, 2, device=dev), 8, 8)
    v = torch.ones(16, device=dev)
    bias_bn_relu(x, v, v, v, v)
    cell = _cell_inputs(dev, 2, 8, 16)
    lstm_cell(*cell)
    assert launch_counts() == {
        "conv3x3_affine": 1, "conv3x3_add_affine": 1, "up2_conv3_affine": 1, "pose_head": 1,
        "gaussian_render": 1, "pose_head_backward": 0, "gaussian_render_backward": 0,
        "bias_bn_relu": 1, "lstm_cell": 1,
    }
    with pytest.raises(TypeError):
        lstm_cell(cell[0].float(), *cell[1:])  # the input in f32
    with pytest.raises(TypeError):
        lstm_cell(*cell[:2], cell[2].bfloat16(), *cell[3:])  # the cell state in bf16
    with pytest.raises(ValueError):
        lstm_cell(*cell[:3], cell[3][1:], cell[4])  # a kernel of another depth
    with pytest.raises(TypeError):
        bias_bn_relu(x.half(), v.half(), v, v, v)
    with pytest.raises(TypeError):
        bias_bn_relu(x.bfloat16(), v, v, v, v)  # the conv bias in another dtype
    with pytest.raises(ValueError, match="dense"):
        bias_bn_relu(x.transpose(1, 2), v, v, v, v)
    with pytest.raises(ValueError):
        bias_bn_relu(x, v, v[:8], v, v)
    with pytest.raises(TypeError):
        conv3x3_affine(x.half(), k.half(), s, t)
    with pytest.raises(ValueError, match="addend"):
        conv3x3_add_affine(x, k, torch.zeros(1, 8, 8, 8, device=dev), s, t)
    with pytest.raises(ValueError):
        pose_head(torch.zeros(1, 8, 8, 4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        gaussian_render(torch.zeros(1, 4, 2, device=dev), 8, 8, out_dtype=torch.float64)


def test_generate_on_card_matches_cpu(dev):
    """The smoke config, f32: the card's kernel path against the CPU's plain
    path, same parameters and inputs."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cpu = FinalGenerator(cfg, device="cpu")
    params = cpu.init_parameters(0)
    cpu.load_parameters(params)
    engine = InferenceEngine(cfg, params, device="cuda")
    rng = np.random.default_rng(0)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(cfg.model.n_action, dtype=np.float32)[[1, 4]]
    z = np.stack([request_z(s, cfg.model.vae_dim) for s in (3, 4)])
    reset_launch_counts()
    got = engine.final.generate(im, act, z)
    assert launch_counts() == {
        "conv3x3_affine": 8, "conv3x3_add_affine": 1, "up2_conv3_affine": 2, "pose_head": 1,
        "gaussian_render": 2, "pose_head_backward": 0, "gaussian_render_backward": 0,
        "bias_bn_relu": 28, "lstm_cell": 0,
    }
    want = cpu.generate(im, act, z)
    for key in ("current_points", "future_points", "pred_im_seq", "mask"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-4)


def test_tf1_bundle_read_at_full_width_onto_the_card(dev, tmp_path):
    """The generation parameters at Config() width, under the reference's
    TF1 names and layouts in a bundle of chip_smoke.write_tf_bundle, read by
    utils/tf_bundle.py (every tensor's crc32c checked) onto the card: every
    mapped tensor matched, each the original's bits; generate from them
    gives the directly loaded generator's bits."""
    from chip_smoke import write_tf_bundle
    from kpvid_tpu_torch.bridge import to_flax_layout
    from kpvid_tpu_torch.utils.tf1_import import map_names, transcode_tf1_checkpoint

    cfg = Config().validate()
    direct = FinalGenerator(cfg, device="cuda")
    params = direct.init_parameters(0)
    direct.load_parameters(params)
    tensors = {}
    for stage in ("stage1", "stage2"):
        mapping = map_names([k for k in params if k.startswith(stage + ".")], stage)
        tensors.update({tf: to_flax_layout(params[k]) for k, tf in mapping.items()})
    write_tf_bundle(tmp_path / "model.ckpt", tensors)
    gen = FinalGenerator(cfg, device="cuda")
    state = gen.model.state_dict()
    for stage in ("stage1", "stage2"):
        target = {k: v for k, v in state.items() if k.startswith(stage + ".")}
        merged, report = transcode_tf1_checkpoint(str(tmp_path / "model.ckpt"), target, stage)
        assert len(report["matched"]) == len(target)
        assert not report["missing"] and not report["mismatched"]
        for k, v in merged.items():
            assert v.device.type == "cuda" and torch.equal(v.cpu(), params[k]), k
        state.update(merged)
    gen.load_parameters(state)
    rng = np.random.default_rng(2)
    im = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    act = np.eye(cfg.model.n_action, dtype=np.float32)[[3, 5]]
    z = np.stack([request_z(s, cfg.model.vae_dim) for s in (5, 6)])
    got, want = gen.generate(im, act, z), direct.generate(im, act, z)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_generate_bf16_on_card_matches_plain(dev):
    """The smoke config in bfloat16 on the card: the kernel path against the
    same call through the plain versions. Its widths put C = 4 on the last
    octave and the heads, the bf16 kernel's element-wise loader. BN
    statistics, BN scales and biases are drawn at random, so that the
    outputs are not the near-zero ones of the init laws."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    gen = FinalGenerator(cfg, device="cuda")
    params = gen.init_parameters(0)
    g = torch.Generator().manual_seed(1)
    for key, val in params.items():
        if key.endswith("running_var"):
            val.uniform_(0.5, 2.0, generator=g)
        elif key.endswith(".bn.weight"):
            val.uniform_(0.5, 1.5, generator=g)
        elif key.endswith(("running_mean", "bias")):
            val.normal_(0.0, 0.1, generator=g)
    gen.load_parameters(params)
    rng = np.random.default_rng(1)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(cfg.model.n_action, dtype=np.float32)[[2, 5]]
    z = np.stack([request_z(s, cfg.model.vae_dim) for s in (5, 6)])
    reset_launch_counts()
    got = gen.generate(im, act, z)
    # the decode's graph is captured: lstm_cell counts the eager warm-up's
    # launches and the captured ones, a step and layer each
    assert _counts(gen.model.motion_decode) == (1, 1, 0)
    assert launch_counts() == {
        "conv3x3_affine": 8, "conv3x3_add_affine": 1, "up2_conv3_affine": 2, "pose_head": 1,
        "gaussian_render": 2, "pose_head_backward": 0, "gaussian_render_backward": 0,
        "bias_bn_relu": 28, "lstm_cell": 2 * 2 * cfg.model.n_future_frames,
    }
    # the plain versions, the decode eager (a replay would run the captured kernels)
    with mock.patch.object(GraphedDecode, "graphable", lambda self, z: False), \
            contextlib.ExitStack() as stack:
        for target, fn in (
            ("kpvid_tpu_torch.ops.chain.conv3x3_affine", ops.conv3x3_affine_plain),
            ("kpvid_tpu_torch.ops.chain.up2_conv3_affine", ops.up2_conv3_affine_plain),
            ("kpvid_tpu_torch.eval.final.conv3x3_add_affine", ops.conv3x3_add_affine_plain),
            ("kpvid_tpu_torch.models.networks.pose_head", ops.heatmaps_to_keypoints),
            ("kpvid_tpu_torch.eval.final.gaussian_render", ops.render_gaussian_maps),
            ("kpvid_tpu_torch.models.layers.bias_bn_relu", ops.bias_bn_relu_plain),
            ("kpvid_tpu_torch.models.layers.lstm_cell", ops.lstm_cell_plain),
        ):
            stack.enter_context(mock.patch(target, fn))
        want = gen.generate(im, act, z)
    assert _counts(gen.model.motion_decode) == (1, 1, 1)
    torch.testing.assert_close(got["current_points"], want["current_points"], rtol=0, atol=1e-4)
    fut = want["future_points"].float()
    assert (got["future_points"].float() - fut).abs().max() <= 2.0**-8 * fut.abs().max()
    for key in ("pred_im_seq", "pred_im_crude", "mask"):
        _close(got[key], want[key], torch.bfloat16)


def _randomized(gen, seed):
    params = gen.init_parameters(seed)
    g = torch.Generator().manual_seed(seed + 1)
    for key, val in params.items():
        if key.endswith("running_var"):
            val.uniform_(0.5, 2.0, generator=g)
        elif key.endswith(".bn.weight"):
            val.uniform_(0.5, 1.5, generator=g)
        elif key.endswith(("running_mean", "bias")):
            val.normal_(0.0, 0.1, generator=g)
    return params


def test_microbatcher_pipeline_bit_identical_on_card(dev):
    """The smoke config in bfloat16 behind a MicroBatcher on the card: the
    depth-1 pipeline (readback on a second stream while the next batch
    launches) gives the same bits as waiting for each batch."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    engine = InferenceEngine(cfg, _randomized(FinalGenerator(cfg, device="cpu"), 2), device="cuda")
    rng = np.random.default_rng(2)
    n = 12
    images = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    zs = [request_z(200 + i, cfg.model.vae_dim) for i in range(n)]
    results = {}
    for pipelined in (False, True):
        batcher = MicroBatcher(engine, buckets=(2, 4), max_wait_ms=0.0, pipeline=pipelined)
        try:
            batcher.warmup()
            futs = [batcher.submit(images[i], i % cfg.model.n_action, zs[i]) for i in range(n)]
            results[pipelined] = [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()
        assert batcher.stats()["batches_total"] >= 3
    for a, b in zip(results[False], results[True]):
        for key in engine.OUTPUT_KEYS:
            np.testing.assert_array_equal(a[key], b[key])


def test_labeling_chunk_matches_plain_soft_argmax(dev, tmp_path):
    """One 128-frame labeling chunk at Config() widths, bf16, on the card:
    the labeler's keypoints are the pose_head kernel's on the chunk's raw
    maps, within 1e-5 of the plain soft-argmax on the same maps."""
    from kpvid_tpu_torch.checkpoint import save_parameters
    from kpvid_tpu_torch.device import to_device
    from kpvid_tpu_torch.make_pseudo_labels import detect_u8, load_pose_encoder

    cfg = Config().validate()
    save_parameters(tmp_path / "s1.npz", _randomized(FinalGenerator(cfg, device="cpu"), 3))
    enc, n = load_pose_encoder(cfg, str(tmp_path / "s1.npz"), dev)
    assert n == len(enc.state_dict())
    rng = np.random.default_rng(3)
    slab = to_device(rng.integers(0, 256, (128, 128, 128, 3), dtype=np.uint8), dev)
    with torch.no_grad():
        reset_launch_counts()
        got = detect_u8(enc, slab)
        assert launch_counts()["pose_head"] == 1
        raw = enc.raw_maps(slab.float() / 255.0 * 2.0 - 1.0)
    assert raw.dtype == torch.bfloat16 and raw.shape == (128, 128, 128, 40)
    assert torch.equal(got, pose_head(raw.contiguous()))
    assert float((got - heatmaps_to_keypoints(raw)).abs().max()) <= 1e-5


def test_render_point_images_on_card_match_plain(dev):
    """evaluate's point images at 128^2 (#4 then the plain tint): the current
    points on the f32 grid into f32 maps, the future points on the bf16 grid
    into bf16 maps, against the plain render of the same points (bf16 images
    within one bf16 step of the larger magnitude)."""
    from kpvid_tpu_torch.ops import colorize_point_maps
    from kpvid_tpu_torch.utils import get_n_colors

    cfg = Config()
    gen = FinalGenerator(cfg, device=dev)
    colors = get_n_colors(cfg.model.n_pts)
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, dtype in ((8, torch.float32), (256, torch.bfloat16)):
        mu = (torch.rand((rows, cfg.model.n_pts, 2), generator=g, device=dev) * 2 - 1).to(dtype)
        reset_launch_counts()
        got = gen.render_point_images(mu, colors)
        assert launch_counts()["gaussian_render"] == 1
        want = colorize_point_maps(render_gaussian_maps(mu.float(), 128, 128,
                                                        cfg.model.heatmap_inv_std, dtype, dtype),
                                   colors)
        assert got.dtype == dtype and got.shape == (rows, 128, 128, 3)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            err = (got.float() - want.float()).abs()
            assert bool((err <= 2.0**-7 * torch.maximum(got.float().abs(), want.float().abs())
                         + 2.0**-126).all())


def test_stage2_grads_on_card_match_cpu(dev):
    """One fused step's losses and gradients at small widths, f32 with TF32
    off, on the card and on the CPU from the same parameters, batch and
    noise: losses rtol 1e-5, gradients within 2e-3 of each tensor's max.
    The encoder's gradients are ill-conditioned: the KL term's
    d/dsigma = sigma - 1/sigma is large where the relu'd sigma is small and
    carries the rounding of sigma itself, so the encoder's f32 gradients
    depend on the order of every sum before it, on either side."""
    import dataclasses

    from kpvid_tpu_torch.configs import ModelConfig, TrainingConfig
    from kpvid_tpu_torch.train import Stage2Trainer

    cfg = dataclasses.replace(
        Config(), model=ModelConfig(n_pts=8, cell_info=(64, 64), vae_dim=16, n_future_frames=8,
                                    image_size=32, heatmap_size=8),
        training=TrainingConfig(compute_dtype="float32", batch_size=4)).validate()
    rng = np.random.default_rng(0)
    batch = {"keypoints": rng.uniform(-1, 1, (4, 8, 2)).astype(np.float32),
             "real_seq": rng.uniform(-1, 1, (4, 8, 8, 2)).astype(np.float32),
             "action_code": np.eye(9, dtype=np.float32)[[0, 3, 5, 8]]}
    noise = rng.standard_normal((4, 16)).astype(np.float32)
    out = {}
    for device in (dev, "cpu"):
        t = Stage2Trainer(cfg, device=device)
        t.load_parameters(t.init_parameters(3))
        first_pt, real_seq, act = t._flatten_batch(batch)
        g_grads, pred, g_m = t.g_grads(first_pt, real_seq, act, noise)
        d_grads, d_m = t.d_grads(real_seq, pred)
        out[str(device)] = ({k: float(v) for k, v in {**g_m, **d_m}.items()},
                            [g.cpu() for g in list(g_grads) + list(d_grads)])
    (lc, gc), (lp, gp) = out[str(dev)], out["cpu"]
    for k in lp:
        assert lc[k] == pytest.approx(lp[k], rel=1e-5), k
    for a, b in zip(gc, gp):
        assert float((a - b).abs().max()) <= 2e-3 * max(float(b.abs().max()), 1e-30)


def _op_cases(dev):
    """Arguments of each torch.ops.kpvid op on the card, f32 and bf16."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 12, generator=g).to(dev)
    k = (torch.randn(3, 3, 12, 8, generator=g) / 10).to(dev)
    sc, sh = (torch.rand(8, generator=g) + 0.5).to(dev), (torch.randn(8, generator=g) / 10).to(dev)
    add = torch.randn(1, 6, 5, 8, generator=g).to(dev)
    raw = (3 * torch.randn(2, 9, 7, 8, generator=g)).to(dev)
    pts, p, q = torch.ops.kpvid.pose_head_train(raw)
    ct = torch.randn(2, 8, 2, generator=g).to(dev)
    mu = (torch.rand(3, 8, 2, generator=g) * 2 - 1).to(dev)
    dmaps = torch.randn(3, 8, 6, 8, generator=g).to(dev)
    cb = (torch.randn(12, generator=g) / 10).to(dev)
    m12 = (torch.rand(12, generator=g) + 0.5).to(dev)
    s12 = (torch.randn(12, generator=g) / 10).to(dev)
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "conv3x3_affine": [(x, k, sc, sh, True), (x.to(bf16), k.to(bf16), sc, sh, False)],
        "conv3x3_add_affine": [(x, k, add, sc, sh, True),
                               (x.to(bf16), k.to(bf16), add, sc, sh, False)],
        "up2_conv3_affine": [(x, k, sc, sh, True), (x.to(bf16), k.to(bf16), sc, sh, False)],
        "pose_head": [(raw,), (raw.to(bf16),)],
        "pose_head_train": [(raw,), (raw.to(bf16),)],
        "pose_head_backward": [(ct, pts, p, q, f32), (ct, pts, p, q, bf16)],
        "gaussian_render": [(mu, 8, 6, 14.3, f32, f32), (mu, 8, 6, 14.3, bf16, bf16)],
        "gaussian_render_backward": [(dmaps, mu, 14.3, f32), (dmaps.to(bf16), mu, 14.3, bf16)],
        "bias_bn_relu": [(x, cb, s12, m12, s12, True),
                         (x.to(bf16), cb.to(bf16), s12, m12, s12, False),
                         (x[..., :6].contiguous(), cb[:6], s12[:6], m12[:6], s12[:6], True)],
        "lstm_cell": [_cell_inputs(dev, 3, 32, 64), _cell_inputs(dev, 17, 20, 36)],
    }


@pytest.mark.parametrize("name", ["conv3x3_affine", "gaussian_render", "gaussian_render_backward",
                                  "pose_head", "pose_head_backward", "pose_head_train",
                                  "up2_conv3_affine", "conv3x3_add_affine", "bias_bn_relu",
                                  "lstm_cell"])
def test_opcheck_on_card(dev, name):
    """Each op's schema, fake implementation (shapes, dtypes and strides of
    the kernel's output) and autograd registration against its CUDA
    implementation, the kernel."""
    for args in _op_cases(dev)[name]:
        torch.library.opcheck(getattr(torch.ops.kpvid, name).default, args)


@pytest.mark.parametrize("traced_on", ["cpu", "cuda"])
def test_artifact_runs_on_card_through_the_kernels(dev, tmp_path, traced_on):
    """The smoke config in bfloat16: an artifact traced on the CPU (no card
    needed to write it) or on the card, loaded onto the card, launches
    8 / 1 / 2 / 1 / 2 / 28 kernels a batch (#1 / #1+ / #2 / #3 / #4 / bias_bn_relu) and serves
    what the live engine serves:
    uint8 within one step, points within 1e-5. The motion decode is traced
    eager, one lstm_cell op a step and layer, which the artifact runs as
    the kernel on the card wherever it was traced."""
    from kpvid_tpu_torch.eval import ArtifactEngine, export_serving, load_serving

    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    params = _randomized(FinalGenerator(cfg, device="cpu"), 4)
    live = InferenceEngine(cfg, params, device="cuda")
    path = tmp_path / "serving.npz"
    reset_launch_counts()
    export_serving(live.final, path, batch_sizes=(1, 2), device=traced_on)
    assert sum(launch_counts().values()) == 0
    engine = ArtifactEngine(load_serving(path, device="cuda"))
    assert engine.buckets == (1, 2) and engine.device.type == "cuda"
    # nothing of the tracing device is left in the moved graphs
    for program in engine.artifact.programs.values():
        assert not [n for n in program.graph.nodes
                    if "cpu" in str(n.kwargs.get("device", "")) or any(
                        isinstance(a, torch.device) and a.type == "cpu" for a in n.args)]
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    actions = np.asarray([3, 7])
    z = np.stack([request_z(s, cfg.model.vae_dim) for s in (8, 9)])
    want = live.run(images, actions, z)
    reset_launch_counts()
    got = engine.run(images, actions, z)
    assert launch_counts() == {
        "conv3x3_affine": 8, "conv3x3_add_affine": 1, "up2_conv3_affine": 2, "pose_head": 1,
        "gaussian_render": 2, "pose_head_backward": 0, "gaussian_render_backward": 0,
        "bias_bn_relu": 28, "lstm_cell": 2 * cfg.model.n_future_frames,
    }
    for key in ("pred_im_seq", "mask"):
        assert got[key].dtype == np.uint8
        assert int(np.abs(got[key].astype(np.int16) - want[key].astype(np.int16)).max()) <= 1, key
    for key in ("current_points", "future_points"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.fixture
def group_of_one(dev):
    """This process alone in a process group on NCCL and the card, through
    the KPVID_* contract; torn down after the test."""
    import socket

    import torch.distributed as dist

    from kpvid_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"KPVID_COORDINATOR": f"127.0.0.1:{port}", "KPVID_NUM_PROCESSES": "1",
           "KPVID_PROCESS_ID": "0"}
    with mock.patch.dict("os.environ", env):
        assert parallel.maybe_initialize("cuda") is False  # one process
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


def test_sync_batchnorm_on_card_matches_cpu(dev, group_of_one):
    """Sync-BN at world size 1: its forward and its backward through the
    differentiable all-reduce give the plain train-mode BN's bits on the
    card, and the CPU's values (f32: rtol 1e-5, atol 1e-6), the moving
    statistics included."""
    from kpvid_tpu_torch.models import BatchNorm, syncing_batch_stats, updating_batch_stats

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, 8, 16, generator=g) * 2 + 0.5
    w = torch.randn(4, 8, 8, 16, generator=g)
    state = {"weight": torch.rand(16, generator=g) + 0.5, "bias": torch.randn(16, generator=g),
             "running_mean": torch.randn(16, generator=g),
             "running_var": torch.rand(16, generator=g) + 0.5}

    def run(device, sync):
        bn = BatchNorm(16).to(device)
        bn.load_state_dict(state)
        xd = x.to(device).requires_grad_(True)
        with updating_batch_stats(bn), syncing_batch_stats(bn, sync):
            y = bn(xd, train=True)
        gx, gw, gb = torch.autograd.grad((y * w.to(device)).sum(), (xd, bn.weight, bn.bias))
        return [t.detach().cpu() for t in (y, gx, gw, gb, bn.running_mean, bn.running_var)]

    synced, plain, cpu = run(dev, True), run(dev, False), run(torch.device("cpu"), False)
    for a, b, c in zip(synced, plain, cpu):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


def test_bf16_bucket_reduce_on_card(dev, group_of_one):
    """The data-parallel gradient reduction at world size 1 on NCCL: the bf16
    bucket gives each gradient rounded to bf16 once (the sum over one rank
    and the division by 1 are exact) and back in f32; the f32 bucket gives
    the gradients' bits; the metrics come back as they went in."""
    from kpvid_tpu_torch.train.state import make_reduce_hooks

    g = torch.Generator().manual_seed(5)
    grads = [torch.randn(shape, generator=g).to(dev) for shape in ((64, 3, 3, 3), (64,), (7, 1000))]
    reduce16, reduce_metrics = make_reduce_hooks(True, "bfloat16")
    reduce32, _ = make_reduce_hooks(True, "float32")
    for got, want in zip(reduce16(grads), grads):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want.to(torch.bfloat16).float())
    assert all(torch.equal(a, b) for a, b in zip(reduce32(grads), grads))
    metrics = {"loss_G": torch.tensor(1.25, device=dev), "loss_D": torch.tensor(0.5, device=dev)}
    assert {k: float(v) for k, v in reduce_metrics(metrics).items()} == {"loss_G": 1.25,
                                                                        "loss_D": 0.5}


def test_mesh_engine_two_replicas_on_card(dev):
    """The engine over two replicas on one card (each on its own streams,
    each reading back into its rows of the batch's pinned buffers): each
    replica's rows are one replica's bits on those rows alone; the engine
    over the default device list (every visible card) and over the one
    device give the bits of generate on the default stream, read back
    there."""
    from kpvid_tpu_torch.eval.final import mesh_devices
    from kpvid_tpu_torch.eval.server import one_hot, serve_outputs

    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    params = _randomized(FinalGenerator(cfg, device="cpu"), 3)
    one = InferenceEngine(cfg, params, device="cuda")
    two = InferenceEngine(cfg, params, devices=[dev, dev])
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    actions = np.arange(4) % cfg.model.n_action
    z = np.stack([request_z(300 + i, cfg.model.vae_dim) for i in range(4)])
    got = two.run(images, actions, z)
    for i in range(2):
        alone = one.run(images[2 * i:2 * i + 2], actions[2 * i:2 * i + 2], z[2 * i:2 * i + 2])
        for key in one.OUTPUT_KEYS:
            np.testing.assert_array_equal(got[key][2 * i:2 * i + 2], alone[key])
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(params)
    want = {k: v.cpu().numpy() for k, v in serve_outputs(
        gen.generate(images, one_hot(actions, cfg.model.n_action), z)).items()}
    default = InferenceEngine(cfg, params, devices=mesh_devices("cuda"))
    for engine in (default, one):
        whole = engine.run(images, actions, z)
        for key in one.OUTPUT_KEYS:
            np.testing.assert_array_equal(whole[key], want[key])


def test_evaluate_two_replicas_read_back_on_their_streams(dev, tmp_path):
    """evaluate --mesh over two replicas on one card, with each replica's
    point images written after a spin kernel on its stream: the replicas'
    streams do not wait for the default stream, so only a readback queued
    on the replica's own stream reads the finished outputs. The tree is the
    tree without the delay, byte for byte, after a run with other latents
    has left other values in the blocks the outputs reuse."""
    import dataclasses
    import json

    from kpvid_tpu_torch import evaluate
    from kpvid_tpu_torch.checkpoint import save_parameters
    from kpvid_tpu_torch.data import make_synthetic_penn_tree, make_synthetic_pseudo_labels
    from kpvid_tpu_torch.eval import final as final_mod

    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    save_parameters(tmp_path / "p.npz", _randomized(FinalGenerator(cfg, device="cpu"), 5))
    make_synthetic_penn_tree(tmp_path / "penn", n_train=1, n_test=4)
    make_synthetic_pseudo_labels(tmp_path / "penn", n_pts=cfg.model.n_pts)
    (tmp_path / "eval.yaml").write_text(json.dumps({
        "paths": {"data_dir": str(tmp_path / "penn")},
        "training": {"compute_dtype": "bfloat16"}, "model": dataclasses.asdict(cfg.model),
        "data": {"num_workers": 1, "eval_batch_size": 4,
                 "sequence_len": cfg.model.n_future_frames + 1}}))
    render = FinalGenerator.render_point_images

    def delayed(self, *args):
        # the point images written after ~0.1 s of spinning on the replica's
        # stream, after the host's last wait on it (the colors' copy)
        out = render(self, *args)
        torch.cuda._sleep(200_000_000)
        return out.clone()

    def tree(name, seed, render_fn):
        with mock.patch.object(final_mod, "mesh_devices", lambda device: [dev, dev]), \
                mock.patch.object(FinalGenerator, "render_point_images", render_fn):
            stats = evaluate.main(["--config", str(tmp_path / "eval.yaml"), "--checkpoint_stage1",
                                   str(tmp_path / "p.npz"), "--checkpoint_stage2",
                                   str(tmp_path / "p.npz"), "--save_dir", str(tmp_path / name),
                                   "--seed", str(seed), "--png-workers", "2", "--mesh"])
        assert stats["batches"] == 1 and stats["samples"] == 4
        return {p.relative_to(tmp_path / name).as_posix(): p.read_bytes()
                for p in sorted((tmp_path / name).rglob("*.png"))}

    want = tree("plain", 0, render)
    # other latents: other values in the blocks the delayed run's outputs reuse
    other = tree("other", 1, render)
    got = tree("delayed", 0, delayed)
    assert sorted(got) == sorted(want) and len(want) == 4 * (2 + 5 * cfg.model.n_future_frames)
    assert any(other[k] != want[k] for k in want)
    assert [k for k in want if got[k] != want[k]] == []


def test_evaluate_launch_returns_while_a_replica_is_busy(dev):
    """evaluate --mesh's launch (generate and both point images) over two
    replicas on one card queues its work with no wait on the host: with a
    spin kernel of ~0.5 s queued first on replica 0's stream, ``map``
    returns while that stream is still busy, in well under the spin's time.
    A host array of colors copied to the card inside the launch waits for
    the replica's stream, so the replicas ran one after another. Four
    future frames keep the launches queued behind the spin below the
    CUDA queue of pending launches on a stream, past which any launch
    waits on the host."""
    from kpvid_tpu_torch.eval.final import GeneratorMesh
    from kpvid_tpu_torch.evaluate import make_launch
    from kpvid_tpu_torch.utils import get_n_colors

    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    cfg.model.n_future_frames = 4
    m = cfg.model
    mesh = GeneratorMesh(cfg, _randomized(FinalGenerator(cfg, device="cpu"), 5), [dev, dev])
    launch = make_launch(get_n_colors(m.n_pts))
    rng = np.random.default_rng(8)
    rows = (rng.uniform(-1, 1, (4, m.image_size, m.image_size, 3)).astype(np.float32),
            np.eye(m.n_action, dtype=np.float32)[np.arange(4) % m.n_action],
            rng.standard_normal((4, m.vae_dim)).astype(np.float32))
    mesh.map(launch, *rows)  # builds the kernels and fills every cache
    mesh.synchronize()
    stream = mesh.replicas[0].stream
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        start.record()
        torch.cuda._sleep(1_000_000_000)
        end.record()
    t0 = time.perf_counter()
    mesh.map(launch, *rows)
    host_s = time.perf_counter() - t0
    busy = not stream.query()
    mesh.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    assert busy and host_s < 0.5 * spin_s, (busy, host_s, spin_s)


def test_model_axis_join_on_card_is_exact(dev, group_of_one):
    """The tensor-parallel join (parallel/tensor.py) on NCCL and the card,
    in a process group of one (NCCL takes one rank per card, and this
    machine may have one): the uint8 all-reduce returns each element's bits,
    -0.0 and NaN included, in f32 and bf16, and the join and copy_to_model
    pass the cotangent through. With one rank the all-reduce is a copy and
    both backwards are identities, so this cannot catch a wrong offset or a
    backward that sums: the join across ranks is tested on gloo
    (tests/test_torch_tensor_parallel.py, and chip_smoke.py phase 12 on the
    card)."""
    from kpvid_tpu_torch.parallel import ModelShard
    from kpvid_tpu_torch.parallel.tensor import copy_to_model, join

    shard = ModelShard(0, 1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor([[-0.0, float("nan"), 1.5, -3.25]], dtype=dtype, device=dev)
        y = shard.join_(x, -1)
        assert torch.equal(y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           x.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    x = torch.randn(3, 4, device=dev, requires_grad=True)
    g = torch.randn(3, 4, device=dev)
    (gx,) = torch.autograd.grad((join(copy_to_model(x, shard), -1, shard) * g).sum(), x)
    assert torch.equal(gx, g)


# --------------------------------------------------- train_step_multi, graphed
S1_SMOKE = dict(n_pts=8, image_size=32, heatmap_size=8, encoder_filters=8, translator_filters=16,
                pose_decoder_filters=16, discriminator_filters=8)
S2_SMOKE = dict(n_pts=8, cell_info=(64, 64), vae_dim=16, n_future_frames=8, image_size=32,
                heatmap_size=8)
MULTI_K = 3


@pytest.fixture
def deterministic(dev):
    """cuDNN's deterministic algorithms, as the train CLI asks for them."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield dev
    torch.backends.cudnn.deterministic = before


def _multi_setup(stage: int, dev, remat_vgg: bool = False):
    """(a fresh trainer on ``dev`` from seed 3, the stacked inputs of K + 1
    steps, the graphed multi over the first K, one eager step i)."""
    import dataclasses

    from kpvid_tpu_torch.configs import ModelConfig, TrainingConfig
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer

    rng = np.random.default_rng(stage)
    k = MULTI_K + 1
    if stage == 1:
        cfg = dataclasses.replace(Config(), model=ModelConfig(**S1_SMOKE), training=TrainingConfig(
            compute_dtype="float32", batch_size=2, remat_vgg=remat_vgg)).validate()
        vgg = synthesize_vgg19_params(max_width=16)
        stacked = {n: rng.uniform(-1, 1, (k, 2, 32, 32, 3)).astype(np.float32)
                   for n in ("image", "future_image")}
    else:
        cfg = dataclasses.replace(Config(), model=ModelConfig(**S2_SMOKE), training=TrainingConfig(
            compute_dtype="float32", batch_size=4)).validate()
        stacked = {"keypoints": rng.uniform(-1, 1, (k, 4, 8, 2)).astype(np.float32),
                   "real_seq": rng.uniform(-1, 1, (k, 4, 8, 8, 2)).astype(np.float32),
                   "action_code": np.eye(9, dtype=np.float32)[rng.integers(0, 9, (k, 4))],
                   "noise": rng.standard_normal((k, 4, 16)).astype(np.float32)}

    def make():
        t = (Stage1Trainer(cfg, vgg, device=dev) if stage == 1
             else Stage2Trainer(cfg, device=dev))
        t.load_parameters(t.init_parameters(3))
        return t

    multi, single = multi_fns(stage, stacked)
    return make, stacked, lambda t: multi(t, MULTI_K), single


def _first_grads(trainer) -> dict:
    """Wrap ``trainer._apply`` to keep each parameter's first gradient, by name."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    out = {}
    apply = trainer._apply

    def recording(opt, params, grads):
        for p, g in zip(params, grads):
            out.setdefault(names[id(p)], g.detach().clone())
        apply(opt, params, grads)

    trainer._apply = recording
    return out


@pytest.mark.parametrize("stage,start,remat", [(1, 0, False), (1, 0, True), (2, 0, False),
                                               (2, 7, False)])
def test_graphed_multi_matches_eager_steps(deterministic, stage, start, remat):
    """The graphed ``train_step_multi`` (one step captured as a CUDA graph,
    replayed K = 3 times) against 3 eager ``train_step``s on the card from
    the same state, f32 with TF32 off, cuDNN's deterministic algorithms on
    both sides (as the train CLI; else a free choice of algorithms, which
    may differ between the two, adds its own rounding to the step's
    sensitivity at batch 2). Stage 2: losses rtol 1e-5 each step,
    parameters within 1e-5, or 2.05 lr where the first gradient is below
    1e-5 of its tensor's max (capturable Adam's bias correction is f32 on
    the card, the eager one's f64 on the host: an ulp of the step, which a
    sign step turns over); from step 7 with a fresh optimizer (an import's
    state) too, which the rates at the optimizer's count must follow.
    Stage 1 (with and without the VGG recompute): the first step's losses
    rtol 1e-5 (both sides step from the same state), parameters within
    JAX's multi envelope 3 lr a step, BN statistics 1e-5; the later steps'
    losses finite only: at batch 2 they take one of two values some 1.5e-4
    apart, eager and graphed alike, as the process's state (the algorithms
    cuDNN and cuBLAS pick) turns a first Adam sign step one way or the
    other (chip_smoke.py phase 13 holds them to 1e-4 at Config()'s batch
    16). Afterwards Adam's step count is a host f32 tensor of K again and
    the step advanced by K."""
    make, _, multi, single = _multi_setup(stage, deterministic, remat)
    a, b = make(), make()
    for t in (a, b):
        t.step = start
    grads = _first_grads(b)
    got = multi(a)
    want = [single(b, i) for i in range(MULTI_K)]
    assert a.step == b.step == start + MULTI_K and len(a._graphs) == 1
    state = next(iter(a.g_opt.state.values()))
    assert state["step"].device.type == "cpu" and int(state["step"]) == MULTI_K
    assert not a.g_opt.param_groups[0]["capturable"]
    lr = a.lr_schedule(0)
    for key in want[0]:
        assert got[key].shape == (MULTI_K,), key
        for i, w in enumerate(want):
            if stage == 2 or i == 0 or key == "lr":
                assert float(got[key][i]) == pytest.approx(float(w[key]), rel=1e-5), (key, i)
            assert np.isfinite(float(got[key][i])), (key, i)
    pa, pb = a.model.state_dict(), b.model.state_dict()
    for name, va in pa.items():
        diff = (va - pb[name]).abs()
        if "running_" in name:
            assert float(diff.max()) <= 1e-5, name
        elif stage == 1:
            assert float(diff.max()) <= 3 * lr * MULTI_K, name
        else:
            g = grads[name].abs()
            sign = g < 1e-5 * float(g.max())
            bound = torch.where(sign, torch.full_like(diff, 2.05 * lr), torch.full_like(diff, 1e-5))
            assert bool((diff <= bound).all()), (name, float(diff.max()))


@pytest.mark.parametrize("stage", [1, 2])
def test_graphed_multi_replays_the_same_bits(deterministic, stage):
    """The captured graph replayed from the same state (copied back in
    place, so the graph stays valid) gives the same bits, and goes with its
    trainer; one replay of the
    stage-1 graph launches #3 once, #4 twice, #3' once and #4' twice (read
    from a torch.profiler trace, as the counters count only the capture),
    stage 2's none of them."""
    make, _, multi, _ = _multi_setup(stage, deterministic)
    t = make()
    before = host_arrays(t)
    multi(t)
    first = host_arrays(t)
    graph = next(iter(t._graphs.values()))
    restore_in_place(t, before)
    multi(t)
    assert next(iter(t._graphs.values())) is graph
    second = host_arrays(t)
    differ = {k: float((first[k].double() - second[k].double()).abs().max()) for k in first
              if not torch.equal(first[k], second[k])}
    assert not differ, differ
    rec = replay_kernels(graph.graph)
    want = ({"conv3x3": 0, "pose_head": 1, "gaussian_render": 2, "pose_head_backward": 1,
             "gaussian_render_backward": 2, "bias_bn_relu": 0, "lstm_cell": 0} if stage == 1
            else {"conv3x3": 0, "pose_head": 0, "gaussian_render": 0, "pose_head_backward": 0,
                  "gaussian_render_backward": 0, "bias_bn_relu": 0, "lstm_cell": 0})
    assert rec["kernels"] > 0 and rec["launches"] == want, rec
    # the graph holds no reference to its trainer: both go with the trainer's
    # last reference, not with a later pass of the garbage collector (which
    # could destroy a graph while another is being captured, ending it)
    refs = weakref.ref(t), weakref.ref(graph)
    del t, graph
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("stage", [1, 2])
def test_load_state_arrays_forces_a_recapture(deterministic, stage):
    """``load_state_arrays`` gives Adam new tensors: the graph is dropped and
    the next call captures anew, and from the reloaded state the new graph
    repeats the first call's bits."""
    make, _, multi, _ = _multi_setup(stage, deterministic)
    t = make()
    before = host_arrays(t)
    multi(t)
    first, graph = host_arrays(t), next(iter(t._graphs.values()))
    t.load_state_arrays(before)
    assert not t._graphs and not graph.valid(t)
    multi(t)
    assert next(iter(t._graphs.values())) is not graph
    second = host_arrays(t)
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_graphed_multi_after_eager_steps_and_state_round_trip(deterministic):
    """Eager steps, then the graphed multi, then state_arrays into a fresh
    trainer: its next eager step gives the bits of one more eager step on
    the original (stage 2)."""
    make, stacked, multi, single = _multi_setup(2, deterministic)
    a = make()
    single(a, 0)
    multi(a)
    b = make()
    b.load_state_arrays(host_arrays(a))
    for t in (a, b):
        single(t, MULTI_K)
    assert a.step == b.step == MULTI_K + 2
    sa, sb = host_arrays(a), host_arrays(b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_a_capture_that_syncs_raises(dev):
    """A host read inside the captured step (a loss as a Python float) stops
    the capture with an error, not a quiet eager loop; the trainer is left
    as it was (step, Adam's host step count, eager mode) and steps on."""
    make, _, multi, single = _multi_setup(2, dev)
    t = make()
    one = t._one_step

    def syncing(inputs):
        out = one(inputs)
        float(out["loss_G"])
        return out

    t._one_step = syncing
    with pytest.raises(RuntimeError):
        multi(t)
    assert t.step == 0 and not t._graphs and not t._graphing
    assert all(not g["capturable"] and isinstance(g["lr"], float)
               for opt in (t.g_opt, t.d_opt) for g in opt.param_groups)
    assert all(s["step"].device.type == "cpu" for s in t.g_opt.state.values())
    t._one_step = one
    single(t, 0)
    assert t.step == 1


def _decoder(dev, seed: int = 0):
    """A GraphedDecode over Config()'s motion decoder (a 2 x 1024 LSTM over
    32 steps, bf16) on the card, its parameters drawn from ``seed``."""
    from kpvid_tpu_torch.eval.final import GraphedDecode
    from kpvid_tpu_torch.models import MotionGenerator

    m = Config().model
    s2 = MotionGenerator(m.n_pts, m.n_action, m.n_future_frames, m.cell_info, m.vae_dim,
                         torch.bfloat16)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in s2.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5)
    return GraphedDecode(s2.to(dev).eval())


def _decode_inputs(dev, b: int, seed: int = 0) -> tuple:
    """(z, first points, one-hot actions) of ``b`` rows at Config() sizes."""
    m = Config().model
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(b, m.vae_dim, generator=g)
    first = torch.rand(b, 2 * m.n_pts, generator=g) * 2 - 1
    act = torch.eye(m.n_action)[torch.randint(0, m.n_action, (b,), generator=g)]
    return tuple(t.to(dev) for t in (z, first, act))


def _counts(dec) -> tuple:
    return dec.captures, dec.replays, dec.eager_calls


@pytest.mark.parametrize("b", [1, 4, 32])
def test_graphed_decode_matches_eager_bit_for_bit(dev, b):
    """The replayed decode gives the eager decode's bits, at the serve
    buckets' ends and the offline batch: the same ops in the same dtypes,
    the same cuBLAS kernels."""
    dec = _decoder(dev)
    args = _decode_inputs(dev, b)
    with torch.no_grad():
        want = dec.stage2.decode(*args)
        got = dec(*args)
        again = dec(*args)
    torch.cuda.synchronize()
    assert _counts(dec) == (1, 2, 0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(again, want)


def test_graphed_decode_output_outlives_the_next_replay(dev):
    """Each call returns a tensor of its own: the next replay, which
    rewrites the graph's output buffer, leaves the last call's result as it
    was."""
    dec = _decoder(dev)
    with torch.no_grad():
        first = dec(*_decode_inputs(dev, 4, 1))
        kept = first.clone()
        second = dec(*_decode_inputs(dev, 4, 2))
    torch.cuda.synchronize()
    assert _counts(dec) == (1, 2, 0)
    assert torch.equal(first, kept) and not torch.equal(first, second)


def test_graphed_decode_follows_the_parameters(dev):
    """``load_parameters`` copies new values into the same tensors: the next
    replay reads them, with no new capture. A parameter rebound to other
    storage drops the graph, and the next call captures anew."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(_randomized(gen, 5))
    dec = gen.model.motion_decode
    rng = np.random.default_rng(5)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(cfg.model.n_action, dtype=np.float32)[[1, 6]]
    z = np.stack([request_z(s, cfg.model.vae_dim) for s in (11, 12)])

    def eager(out):
        first = out["current_points"].reshape(2, -1)
        return gen.stage2.decode(torch.as_tensor(z, device=dev), first,
                                 torch.as_tensor(act, device=dev)).reshape(
                                     out["future_points"].shape)

    before = gen.generate(im, act, z)
    gen.load_parameters(_randomized(gen, 6))
    after = gen.generate(im, act, z)
    assert _counts(dec) == (1, 2, 0)
    with torch.no_grad():
        assert torch.equal(after["future_points"], eager(after))
    assert not torch.equal(after["future_points"], before["future_points"])
    for p in gen.stage2.parameters():
        p.data = p.data.clone()
    again = gen.generate(im, act, z)
    assert _counts(dec) == (2, 3, 0)
    assert torch.equal(again["future_points"], after["future_points"])


def test_two_replicas_on_one_card_each_replay_their_rows(dev):
    """Two replicas of one mesh on one card, each with its own graphs, pool
    and stream: each replica's rows of the future points are the eager
    decode's of those rows."""
    from kpvid_tpu_torch.eval.final import GeneratorMesh

    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    params = _randomized(FinalGenerator(cfg, device="cpu"), 7)
    mesh = GeneratorMesh(cfg, params, [dev, dev])
    rng = np.random.default_rng(7)
    im = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    act = np.eye(cfg.model.n_action, dtype=np.float32)[[0, 3, 5, 8]]
    z = np.stack([request_z(400 + i, cfg.model.vae_dim) for i in range(4)])
    for _ in range(2):
        got = mesh.run(lambda rep, *rows: rep.final.generate(*rows), im, act, z)
    for i, rep in enumerate(mesh.replicas):
        assert _counts(rep.final.model.motion_decode) == (1, 2, 0)
        rows = slice(2 * i, 2 * i + 2)
        with torch.no_grad():
            first = torch.as_tensor(got["current_points"][rows], device=dev).reshape(2, -1)
            want = rep.final.stage2.decode(torch.as_tensor(z[rows], device=dev), first,
                                           torch.as_tensor(act[rows], device=dev))
        np.testing.assert_array_equal(got["future_points"][rows],
                                      want.float().reshape(2, *got["future_points"].shape[1:])
                                      .cpu().numpy())


def test_a_callers_capture_takes_the_eager_decode(deterministic):
    """Under a stream capture that is not its own (the graphed stage-2 step,
    chip_smoke.py's device timings) the decode runs eager inside it, and
    counts so: the captured caller replays the decode's bits. The stage-2
    trainer's graphed step still captures and steps."""
    make, _, multi, _ = _multi_setup(2, deterministic)
    t = make()
    multi(t)
    assert len(t._graphs) == 1 and t.step == MULTI_K
    dec = _decoder(deterministic)
    args = _decode_inputs(deterministic, 4)
    with torch.no_grad():
        want = dec(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            inside = dec(*args)
        graph.replay()
    torch.cuda.synchronize()
    assert _counts(dec) == (1, 1, 1)
    assert torch.equal(inside, want)


def test_daemon_without_warmup_captures_at_a_buckets_first_batch(dev):
    """``--no_warmup``: each bucket's decode graph is captured at its first
    batch, while the pipeline's readbacks of the batch before are in flight
    on the copy stream; the answers are those of an engine that captured in
    its warm-up, and no decode ran eager."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = "bfloat16"
    params = _randomized(FinalGenerator(cfg, device="cpu"), 8)
    rng = np.random.default_rng(8)
    n = 12
    images = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    zs = [request_z(500 + i, cfg.model.vae_dim) for i in range(n)]
    results = {}
    for warm in (True, False):
        engine = InferenceEngine(cfg, params, device="cuda")
        batcher = MicroBatcher(engine, buckets=(2, 4), max_wait_ms=0.0, pipeline=True)
        try:
            if warm:
                batcher.warmup()
            futs = [batcher.submit(images[i], i % cfg.model.n_action, zs[i]) for i in range(n)]
            results[warm] = [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()
        dec = engine.final.model.motion_decode
        assert dec.eager_calls == 0 and 1 <= dec.captures <= 2 and dec.replays >= 3
    for a, b in zip(results[True], results[False]):
        for key in InferenceEngine.OUTPUT_KEYS:
            np.testing.assert_array_equal(a[key], b[key])


def test_graphed_decode_counters_and_the_profiler(dev):
    """After a warm-up call and k calls: one capture, k + 1 replays. Under a
    profiler a shape with a graph replays (its range ``kpvid.graph.
    motion_decode`` and the graph's launch in the trace); a new shape runs
    eager, with no capture; it is captured at its first call after."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    dec = _decoder(dev)
    four, two = _decode_inputs(dev, 4), _decode_inputs(dev, 2)
    k = 3
    with torch.no_grad():
        for _ in range(k + 1):
            dec(*four)
        assert _counts(dec) == (1, k + 1, 0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dec(*four)
            dec(*two)
            torch.cuda.synchronize()
        assert _counts(dec) == (1, k + 2, 1)
        dec(*two)
    assert _counts(dec) == (2, k + 3, 1)
    events = list(prof.profiler.kineto_results.events())
    host = [e.name() for e in events if e.device_type() == DeviceType.CPU]
    assert host.count("kpvid.graph.motion_decode") == 1
    assert any("GraphLaunch" in n for n in host), sorted(set(host))
    # the graph's kernels are linked to the replay's range (an op), which
    # the benchmark's phase readers follow to the phase that queued them
    replay = next(e for e in events if e.name() == "kpvid.graph.motion_decode")
    linked = [e for e in events if e.device_type() == DeviceType.CUDA
              and e.linked_correlation_id() == replay.correlation_id()]
    # among them the decode's LSTM steps: one lstm_cell kernel a step and layer
    steps = len(Config().model.cell_info) * Config().model.n_future_frames
    assert sum("lstm_cell" in e.name() for e in linked) == steps, sorted(
        {e.name() for e in linked})
    assert len(linked) > steps


def test_export_on_the_card_keeps_the_eager_decode(dev):
    """``torch.export`` on the card after a capture traces the eager decode
    (every LSTM step's gates in the program) and captures nothing."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(gen.init_parameters(0))
    m = cfg.model
    args = (torch.zeros(2, m.image_size, m.image_size, 3, device=dev),
            torch.eye(m.n_action, device=dev)[:2], torch.zeros(2, m.vae_dim, device=dev))
    dec = gen.model.motion_decode
    with torch.no_grad():
        gen.model(*args)
        program = torch.export.export(gen.model, args)
    assert _counts(dec) == (1, 1, 1)
    sigmoids = sum("sigmoid" in str(n.target) for n in program.graph.nodes)
    assert sigmoids == 3 * m.n_future_frames * len(m.cell_info) + 1  # + the mask's


# --- kpvid::bias_bn_relu: the encoders' inference bias + BN + ReLU ----------

# every inference ConvBNReLU of the batch-32 generate ([N, H, W, C] of its
# output): the image and pose encoders' trunks (the image trunk's down2/keep2
# no longer run, their shapes are the pose trunk's) and the pose decoder
_TRUNK = [("in0", (32, 128, 128, 32)), ("in1", (32, 128, 128, 32)),
          ("down0", (32, 64, 64, 64)), ("keep0", (32, 64, 64, 64)),
          ("down1", (32, 32, 32, 128)), ("keep1", (32, 32, 32, 128)),
          ("down2", (32, 16, 16, 256)), ("keep2", (32, 16, 16, 256))]
_DECODER = [(f"dec{o}{x}", (32, r, r, c)) for o, (r, c) in
            enumerate([(16, 128), (32, 64), (64, 32), (128, 16)]) for x in "abcd"
            if o < 3 or x in "ab"]
BN_LAYERS = ([(f"image.{n}", s) for n, s in _TRUNK] + [(f"pose.{n}", s) for n, s in _TRUNK]
             + [(f"pose.{n}", s) for n, s in _DECODER])


def _bn_inputs(dev, shape, dtype, seed, nan=False):
    """(y, conv_bias, mean, mul, beta) on the card: random values, and the
    channels of tests/test_torch_bias_bn_relu.py::_edge_inputs that land on
    bf16 ties in the bias add and in the final rounding, negative values and
    signed zeros after the subtraction and after beta; NaN every 97th element
    with ``nan``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=g, device=dev) * 3
    conv_bias, mean, beta = (torch.randn(c, generator=g, device=dev) * 0.3 for _ in range(3))
    weight = torch.randn(c, generator=g, device=dev)
    var = torch.rand(c, generator=g, device=dev) * 1.8 + 0.2
    flat = y.view(-1, c)
    if c >= 3:
        conv_bias[0], mean[0], beta[0] = 2.0**-8, 0.0, -0.0
        flat[:, 0] = 1.0
        flat[::2, 0] = -0.0
        conv_bias[1], mean[1], weight[1], beta[1] = 0.0, 0.75, -1.25, -0.0
        flat[::2, 1] = 0.75
        conv_bias[2], mean[2], weight[2], var[2], beta[2] = 0.0, 0.0, 1.0, 1.0 - 1e-5, 2.0**-8
        flat[:, 2] = 1.0
        flat[::2, 2] = 1.0 + 2.0**-7
    if nan:
        y.view(-1)[::97] = float("nan")
    mul = weight * torch.rsqrt(var + 1e-5)
    return y.to(dtype), conv_bias.to(dtype), mean, mul, beta


def _same_bits(got, want):
    view = torch.int32 if want.dtype == torch.float32 else torch.int16
    assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
    diff = got.view(view) != want.view(view)
    assert not bool(diff.any()), f"{int(diff.sum())} of {diff.numel()} elements differ"


@pytest.mark.parametrize("name,shape", BN_LAYERS, ids=[n for n, _ in BN_LAYERS])
def test_bias_bn_relu_kernel_matches_plain_at_the_generate_layers(dev, name, shape):
    """bf16 at each of the 30 layers' batch-32 shapes: the kernel gives the
    bits of the torch passes on the card (the plain version on CUDA
    tensors), NaN and signed zeros included."""
    args = _bn_inputs(dev, shape, torch.bfloat16, seed=len(name) * 1000 + shape[-1],
                      nan=name.endswith(("in1", "keep2", "dec3b")))
    reset_launch_counts()
    got = bias_bn_relu(*args, True)
    assert launch_counts()["bias_bn_relu"] == 1
    _same_bits(got, bias_bn_relu_plain(*args, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,relu",
    [((1, 1, 1, 16), True), ((1, 5, 3, 16), False), ((32, 64, 64, 64), False),
     # C not a multiple of the 16-byte vector (the one-element kernel);
     # C = 40 (a grid rounded to a multiple of 5 blocks), C = 264
     ((2, 3, 3, 12), True), ((3, 7, 5, 6), False), ((2, 4, 4, 4), True),
     ((4, 9, 7, 40), True), ((2, 11, 13, 264), False), ((0, 4, 4, 16), True)],
)
def test_bias_bn_relu_kernel_matches_plain_at_odd_sizes(dev, dtype, shape, relu):
    args = _bn_inputs(dev, shape, dtype, seed=shape[-1] + sum(shape), nan=True)
    _same_bits(bias_bn_relu(*args, relu), bias_bn_relu_plain(*args, relu))


def test_bias_bn_relu_kernel_off_a_16_byte_boundary(dev):
    """A y that starts 2 bytes into its storage takes the one-element kernel."""
    y, cb, mean, mul, beta = _bn_inputs(dev, (2, 6, 6, 16), torch.bfloat16, seed=5)
    buf = torch.empty(y.numel() + 1, dtype=y.dtype, device=dev)
    shifted = buf[1:].view(y.shape)
    shifted.copy_(y)
    assert shifted.data_ptr() % 16 != 0
    _same_bits(bias_bn_relu(shifted, cb, mean, mul, beta, True),
               bias_bn_relu_plain(y, cb, mean, mul, beta, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 128, 128, 32), (1, 128, 128, 32), (2, 5, 3, 16),
                                   (3, 4, 4, 12)])
def test_bias_bn_relu_kernel_on_channels_first_memory(dev, dtype, shape):
    """[N, H, W, C] over NCHW memory, the layout cuDNN returns for an input
    laid out so: the one-element kernel, the output in the same layout."""
    y, cb, mean, mul, beta = _bn_inputs(dev, shape, dtype, seed=sum(shape), nan=True)
    y = y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    got = bias_bn_relu(y, cb, mean, mul, beta, True)
    assert not got.is_contiguous() and got.permute(0, 3, 1, 2).is_contiguous()
    _same_bits(got, bias_bn_relu_plain(y, cb, mean, mul, beta, True))


def _modules_route(layer, x, up2=False, skip=None, train=False):
    """``ConvBNReLU.forward`` before the op: the conv with its bias, BN, ReLU."""
    if up2:
        x = ops.upsample2x(x)
    if skip is not None:
        x = torch.cat([x.to(layer.conv.dtype), skip.to(layer.conv.dtype)], dim=-1)
    return torch.relu(layer.bn(layer.conv(x), train))


def _generate_through_the_modules(gen, *args):
    """``gen.generate(*args)`` on the route before the op: every inference
    ConvBNReLU as its modules, embed through the full image trunk."""
    from kpvid_tpu_torch.models import Stage1Generator
    from kpvid_tpu_torch.models.layers import ConvBNReLU

    with mock.patch.object(ConvBNReLU, "forward", _modules_route), \
            mock.patch.object(Stage1Generator, "embed",
                              lambda self, im: self.image_encoder(im)[-2]):
        return gen.generate(*args)


def _config_generator(dev, seed):
    cfg = Config().validate()
    cfg.training.compute_dtype = "bfloat16"
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(_randomized(gen, seed))
    return cfg, gen


def test_generate_at_batch_32_gives_the_module_routes_bits(dev):
    """One batch-32 generate at Config() widths in bf16, random BN statistics:
    through the op (28 launches: 30 layers less the image trunk's down2 and
    keep2, which embed no longer runs) against the route before it, each
    inference ConvBNReLU as its conv, BN and ReLU modules and embed through
    the full image trunk: the same bits in every output."""
    cfg, gen = _config_generator(dev, 23)
    m = cfg.model
    rng = np.random.default_rng(23)
    im = rng.uniform(-1, 1, (32, m.image_size, m.image_size, 3)).astype(np.float32)
    act = np.eye(m.n_action, dtype=np.float32)[rng.integers(0, m.n_action, 32)]
    z = rng.standard_normal((32, m.vae_dim)).astype(np.float32)
    reset_launch_counts()
    got = gen.generate(im, act, z)
    assert launch_counts()["bias_bn_relu"] == 28
    reset_launch_counts()
    want = _generate_through_the_modules(gen, im, act, z)
    assert launch_counts()["bias_bn_relu"] == 0
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for key in want:
        _same_bits(got[key].contiguous(), want[key].contiguous())


@pytest.mark.parametrize("b", [1, 3])
def test_generate_from_transposed_images_gives_the_module_routes_bits(dev, b):
    """Images handed over as an HWC view of CHW memory (as a preprocessing
    step may leave them): cuDNN's first conv returns NCHW memory, which the
    op takes and keeps, and the call gives the module route's bits."""
    cfg, gen = _config_generator(dev, 29)
    m = cfg.model
    rng = np.random.default_rng(29 + b)
    chw = rng.uniform(-1, 1, (b, 3, m.image_size, m.image_size)).astype(np.float32)
    im = chw.transpose(0, 2, 3, 1)
    assert not im.flags["C_CONTIGUOUS"]
    act = np.eye(m.n_action, dtype=np.float32)[rng.integers(0, m.n_action, b)]
    z = rng.standard_normal((b, m.vae_dim)).astype(np.float32)
    reset_launch_counts()
    got = gen.generate(im, act, z)
    assert launch_counts()["bias_bn_relu"] == 28
    want = _generate_through_the_modules(gen, im, act, z)
    torch.cuda.synchronize()
    for key in want:
        _same_bits(got[key].contiguous(), want[key].contiguous())


# --- kpvid::lstm_cell: the motion decode's LSTM step -----------------------

# the motion decoder's layers at Config(): (input width, hidden units)
DECODER_LAYERS = [(32, 1024), (1024, 1024)]


def _cell_inputs(dev, b, d, h, seed=0):
    """(x bf16 [b, d], h bf16 [b, h], c f32 [b, h], kernel bf16 [d+h, 4h],
    bias f32 [4h]): h in (-1, 1) as an LSTM's output is, a kernel of
    Xavier's scale, biases N(0, 0.3)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, d, generator=g)
    hid = torch.rand(b, h, generator=g) * 2 - 1
    c = torch.randn(b, h, generator=g)
    kernel = torch.randn(d + h, 4 * h, generator=g) * (2.0 / (d + 5 * h)) ** 0.5
    bias = torch.randn(4 * h, generator=g) * 0.3
    bf16 = torch.bfloat16
    return x.to(bf16).to(dev), hid.to(bf16).to(dev), c.to(dev), kernel.to(bf16).to(dev), bias.to(dev)


def _cell_close(got, want):
    """h and c f32 within 1e-5 (the f32 sums of the same products in another
    order), and the bf16 h the rounding of the op's own f32 h."""
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert got[2].dtype == torch.bfloat16 and torch.equal(got[2], got[0].to(torch.bfloat16))


@pytest.mark.parametrize("b", [1, 4, 20, 32, 40])
@pytest.mark.parametrize("d,h", DECODER_LAYERS)
def test_lstm_cell_kernel_matches_plain_at_the_decoder_shapes(dev, b, d, h):
    """One step at each decoder layer's shape, B from one row to two batch
    tiles (20 and 40 pad their last tile), against the plain step."""
    args = _cell_inputs(dev, b, d, h, seed=b)
    reset_launch_counts()
    got = lstm_cell(*args)
    assert launch_counts()["lstm_cell"] == 1
    _cell_close(got, lstm_cell_plain(*args))


@pytest.mark.parametrize("b,d,h", [(3, 20, 36), (5, 7, 8), (2, 16, 40), (33, 32, 24), (1, 0, 16)])
def test_lstm_cell_kernel_at_odd_shapes(dev, b, d, h):
    """D or H not a multiple of 8 (the element-wise loader), H = 40 (a
    block with units past H), B = 33 (a third batch tile of one row), no
    input (D = 0)."""
    args = _cell_inputs(dev, b, d, h, seed=d + h)
    _cell_close(lstm_cell(*args), lstm_cell_plain(*args))


def test_lstm_cell_kernel_on_strided_inputs(dev):
    """x a step of the decoder's [B, T, D] input (row stride T * D) and h
    a column slice off a 16-byte boundary: the rows the op reads are the
    views', not the memory after them."""
    b, t, d, h = 4, 32, 32, 64
    x, hid, c, kernel, bias = _cell_inputs(dev, b, d, h, seed=9)
    seq = torch.randn(b, t, d, device=dev).to(torch.bfloat16)
    seq[:, 5] = x
    wide = torch.zeros(b, h + 3, device=dev, dtype=torch.bfloat16)
    wide[:, 3:] = hid
    args = (seq[:, 5], wide[:, 3:], c, kernel, bias)
    assert args[0].stride() == (t * d, 1) and args[1].data_ptr() % 16
    _cell_close(lstm_cell(*args), lstm_cell_plain(x, hid, c, kernel, bias))


def test_lstm_cell_gives_the_same_bits_twice(dev):
    for b, (d, h) in ((4, DECODER_LAYERS[1]), (32, DECODER_LAYERS[0]), (3, (20, 36))):
        args = _cell_inputs(dev, b, d, h, seed=b)
        first, second = lstm_cell(*args), lstm_cell(*args)
        for a, c in zip(first, second):
            _same_bits(a, c)


def _decoder_lstm(dev, seed):
    """Config()'s motion decoder LSTM (2 x 1024, bf16) on the card: Xavier-
    uniform kernels, biases N(0, 0.1)."""
    from kpvid_tpu_torch.models import StackedLSTM

    lstm = StackedLSTM(32, Config().model.cell_info, torch.bfloat16)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            if "kernel" in name:
                limit = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * limit)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return lstm.to(dev)


def _exact_forward(lstm, xs):
    """The torch route with each step's gate sums taken in float64 from the
    same bf16 operands and rounded to f32: the dot that any order of f32
    sums approximates."""
    from kpvid_tpu_torch.ops.lstm import cell_update

    b, t = xs.shape[:2]
    n = len(lstm.features)
    kernels = [getattr(lstm, f"lstm_{i}_kernel").to(torch.bfloat16).double() for i in range(n)]
    state = [(xs.new_zeros((b, h), dtype=torch.float32), xs.new_zeros((b, h))) for h in lstm.features]
    outs = []
    for step in range(t):
        inp = xs[:, step]
        for li, (c, h) in enumerate(state):
            z = torch.cat([inp, h], dim=-1).double()
            h, c = cell_update((z @ kernels[li]).float() + getattr(lstm, f"lstm_{li}_bias"), c)
            state[li] = (c, h.to(torch.bfloat16))
            inp = state[li][1]
        outs.append(h)
    return torch.stack(outs, dim=1)


# the B whose data (seed 44) the op and the torch route decode 7.6e-6 apart
# on the mean, each drifting its own way from the f64-summed dot (op 5.0e-6,
# torch route 4.3e-6, on an H100): there the op's mean is held to that dot
# (PERF.md §6)
F64_WITNESS = (4,)


@pytest.mark.parametrize("b", [1, 4, 20, 32])
def test_stacked_lstm_op_route_matches_the_torch_route(dev, b):
    """The decoder's LSTM as MotionGenerator.decode feeds it (dec_in's ReLU
    output at step 0, zeros after) over 32 steps, one lstm_cell a step and
    layer, against the torch route on the same card, within
    test_stacked_lstm_matches_flax's bf16 bounds: max 2e-4, mean 7e-6. Each
    step hands h on rounded to bf16, so two orders of the f32 sums drift
    apart over the steps; at the B of F64_WITNESS the op's mean is held to
    the f64-summed dot instead, which neither order reproduces."""
    lstm = _decoder_lstm(dev, 40 + b)
    t = Config().model.n_future_frames
    xs = torch.zeros(b, t, 32)
    xs[:, 0] = torch.randn(b, 32, generator=torch.Generator().manual_seed(b)).relu()
    xs = xs.to(dev).to(torch.bfloat16)
    with torch.no_grad():
        reset_launch_counts()
        got = lstm(xs)
        assert launch_counts()["lstm_cell"] == 2 * t
        want = lstm._forward_torch(xs)
        again = lstm(xs)
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, t, 1024)
    err = (got - want).abs()
    assert float(err.max()) <= 2e-4, float(err.max())
    if b in F64_WITNESS:
        with torch.no_grad():
            exact = _exact_forward(lstm, xs)
        op = float((got - exact).abs().mean())
        assert op <= 7e-6, (float(err.mean()), op, float((want - exact).abs().mean()))
    else:
        assert float(err.mean()) <= 7e-6, float(err.mean())
    _same_bits(got, again)
