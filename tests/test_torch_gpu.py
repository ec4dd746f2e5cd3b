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

Each ``torch.ops.kpvid`` op passes ``torch.library.opcheck`` on CUDA tensors,
and a serving artifact traced on the CPU or on the card runs on the card
through the kernels: 8 / 2 / 1 / 2 launches a batch, the live engine's
outputs within one uint8 step and 1e-5 on the points.

The conv shapes cover the main path at N = 2 (Config() widths), ragged
spatial tiles, C not a multiple of the 32-channel chunk, Cout not a multiple
of the output-channel tile, ReLU on and off, and C % 8 != 0, which takes the
bf16 kernel's element-wise loader.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from kpvid_tpu_torch import ops
from kpvid_tpu_torch.configs import Config, load_config
from kpvid_tpu_torch.eval import FinalGenerator, InferenceEngine, MicroBatcher, request_z
from kpvid_tpu_torch.ops import (
    conv3x3_affine,
    conv3x3_affine_plain,
    gaussian_render,
    gaussian_render_backward,
    heatmaps_to_keypoints,
    launch_counts,
    pose_head,
    pose_head_backward,
    render_gaussian_maps,
    reset_launch_counts,
    up2_conv3_affine,
    up2_conv3_affine_plain,
)

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
     ((2, 16, 16, 4, 16), True), ((2, 12, 20, 12, 64), False), ((1, 9, 9, 4, 4), False)],
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
     ((2, 10, 6, 24, 72), False), ((2, 8, 8, 4, 16), True), ((2, 5, 7, 12, 8), False)],
)
def test_up2_kernel_matches_plain(dev, dtype, shape, relu):
    x, k, s, t = _conv_inputs(dev, dtype, *shape, seed=1)
    got = up2_conv3_affine(x, k, s, t, relu=relu)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    _close(got, up2_conv3_affine_plain(x, k, s, t, relu=relu), dtype)


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
    # stage 1's training shape; the smoke widths; H = 37; K = 5 (scalar stores)
    [(32, 128, 128, 40), (2, 32, 32, 8), (2, 37, 24, 40), (3, 16, 20, 5)],
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


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,k", [(16, 32, 40), (3, 8, 5), (2, 128, 40), (5, 16, 8)])
def test_render_backward_kernel_matches_plain(dev, out_dtype, n, hw, k):
    """Stage 1's render at [16, 32^2, 40] (the f32 grid), small and odd K,
    and 128^2; the maps' cotangent in the maps' dtype."""
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
    assert counts == {"conv3x3_affine": 0, "up2_conv3_affine": 0, "pose_head": 1,
                      "gaussian_render": 2, "pose_head_backward": 1,
                      "gaussian_render_backward": 2}
    for k in lp:
        assert lc[k] == pytest.approx(lp[k], rel=1e-4), k
    for name, a, b in zip(names, gc, gp):
        if not name.endswith((".conv.bias", "heat.bias")):
            assert float((a - b).norm()) <= 5e-2 * max(float(b.norm()), 1e-30), name


def test_wrappers_count_launches_and_check_inputs(dev):
    reset_launch_counts()
    x, k, s, t = _conv_inputs(dev, torch.float32, 1, 8, 8, 16, 16)
    conv3x3_affine(x, k, s, t)
    up2_conv3_affine(x, k, s, t)
    pose_head(torch.zeros(1, 8, 8, 4, device=dev))
    gaussian_render(torch.zeros(1, 4, 2, device=dev), 8, 8)
    assert launch_counts() == {
        "conv3x3_affine": 1, "up2_conv3_affine": 1, "pose_head": 1, "gaussian_render": 1,
        "pose_head_backward": 0, "gaussian_render_backward": 0,
    }
    with pytest.raises(TypeError):
        conv3x3_affine(x.half(), k.half(), s, t)
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
        "conv3x3_affine": 8, "up2_conv3_affine": 2, "pose_head": 1, "gaussian_render": 2,
        "pose_head_backward": 0, "gaussian_render_backward": 0,
    }
    want = cpu.generate(im, act, z)
    for key in ("current_points", "future_points", "pred_im_seq", "mask"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-4)


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
    assert launch_counts() == {
        "conv3x3_affine": 8, "up2_conv3_affine": 2, "pose_head": 1, "gaussian_render": 2,
        "pose_head_backward": 0, "gaussian_render_backward": 0,
    }
    with contextlib.ExitStack() as stack:
        for target, fn in (
            ("kpvid_tpu_torch.ops.chain.conv3x3_affine", ops.conv3x3_affine_plain),
            ("kpvid_tpu_torch.ops.chain.up2_conv3_affine", ops.up2_conv3_affine_plain),
            ("kpvid_tpu_torch.models.networks.pose_head", ops.heatmaps_to_keypoints),
            ("kpvid_tpu_torch.eval.final.gaussian_render", ops.render_gaussian_maps),
        ):
            stack.enter_context(mock.patch(target, fn))
        want = gen.generate(im, act, z)
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
    raw = (3 * torch.randn(2, 9, 7, 8, generator=g)).to(dev)
    pts, p, q = torch.ops.kpvid.pose_head_train(raw)
    ct = torch.randn(2, 8, 2, generator=g).to(dev)
    mu = (torch.rand(3, 8, 2, generator=g) * 2 - 1).to(dev)
    dmaps = torch.randn(3, 8, 6, 8, generator=g).to(dev)
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "conv3x3_affine": [(x, k, sc, sh, True), (x.to(bf16), k.to(bf16), sc, sh, False)],
        "up2_conv3_affine": [(x, k, sc, sh, True), (x.to(bf16), k.to(bf16), sc, sh, False)],
        "pose_head": [(raw,), (raw.to(bf16),)],
        "pose_head_train": [(raw,), (raw.to(bf16),)],
        "pose_head_backward": [(ct, pts, p, q, f32), (ct, pts, p, q, bf16)],
        "gaussian_render": [(mu, 8, 6, 14.3, f32, f32), (mu, 8, 6, 14.3, bf16, bf16)],
        "gaussian_render_backward": [(dmaps, mu, 14.3, f32), (dmaps.to(bf16), mu, 14.3, bf16)],
    }


@pytest.mark.parametrize("name", ["conv3x3_affine", "gaussian_render", "gaussian_render_backward",
                                  "pose_head", "pose_head_backward", "pose_head_train",
                                  "up2_conv3_affine"])
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
    8 / 2 / 1 / 2 kernels a batch and serves what the live engine serves:
    uint8 within one step, points within 1e-5."""
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
        "conv3x3_affine": 8, "up2_conv3_affine": 2, "pose_head": 1, "gaussian_render": 2,
        "pose_head_backward": 0, "gaussian_render_backward": 0,
    }
    for key in ("pred_im_seq", "mask"):
        assert got[key].dtype == np.uint8
        assert int(np.abs(got[key].astype(np.int16) - want[key].astype(np.int16)).max()) <= 1, key
    for key in ("current_points", "future_points"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
