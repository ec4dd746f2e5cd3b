"""Kernels of kpvid_tpu_torch against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor kpvid_tpu, so on a machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances: float32 with TF32 off agrees to reassociation (rtol 1e-4,
atol 1e-4); bfloat16 outputs round once in the kernel and twice in the plain
version (conv output, then the affine), so they are held to 2% of the
output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from kpvid_tpu_torch.configs import load_config
from kpvid_tpu_torch.eval import FinalGenerator, InferenceEngine, request_z
from kpvid_tpu_torch.ops import (
    conv3x3_affine,
    conv3x3_affine_plain,
    gaussian_render,
    heatmaps_to_keypoints,
    launch_counts,
    pose_head,
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
    [((2, 16, 16, 64, 64), True), ((3, 20, 12, 24, 72), True), ((2, 32, 32, 64, 4), False)],
)
def test_conv3x3_kernel_matches_plain(dev, dtype, shape, relu):
    x, k, s, t = _conv_inputs(dev, dtype, *shape)
    got = conv3x3_affine(x, k, s, t, relu=relu)
    torch.cuda.synchronize()
    _close(got, conv3x3_affine_plain(x, k, s, t, relu=relu), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 64), (2, 7, 5, 16, 8)])
def test_up2_kernel_matches_plain(dev, dtype, shape):
    x, k, s, t = _conv_inputs(dev, dtype, *shape, seed=1)
    got = up2_conv3_affine(x, k, s, t)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    _close(got, up2_conv3_affine_plain(x, k, s, t), dtype)


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


def test_wrappers_count_launches_and_check_inputs(dev):
    reset_launch_counts()
    x, k, s, t = _conv_inputs(dev, torch.float32, 1, 8, 8, 16, 16)
    conv3x3_affine(x, k, s, t)
    up2_conv3_affine(x, k, s, t)
    pose_head(torch.zeros(1, 8, 8, 4, device=dev))
    gaussian_render(torch.zeros(1, 4, 2, device=dev), 8, 8)
    assert launch_counts() == {
        "conv3x3_affine": 1, "up2_conv3_affine": 1, "pose_head": 1, "gaussian_render": 1,
    }
    with pytest.raises(TypeError):
        conv3x3_affine(x.half(), k.half(), s, t)
    with pytest.raises(ValueError):
        pose_head(torch.zeros(1, 8, 8, 4, device=dev, dtype=torch.float64))


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
    }
    want = cpu.generate(im, act, z)
    for key in ("current_points", "future_points", "pred_im_seq", "mask"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-4)
