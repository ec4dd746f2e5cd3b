"""kpvid_tpu_torch ops against kpvid_tpu's, on the CPU.

Each kernel wrapper of the port takes its plain PyTorch version for a CPU
tensor; these tests hold those plain versions against the JAX package's
Pallas kernels run in interpret mode, and the plain ops against their jnp
counterparts. Inputs come from numpy seeds; everything is float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kpvid_tpu.ops import heatmaps_to_keypoints as jax_heatmaps_to_keypoints
from kpvid_tpu.ops import render_gaussian_maps as jax_render_gaussian_maps
from kpvid_tpu.ops import upsample2x as jax_upsample2x
from kpvid_tpu.ops.pallas_conv import conv3x3_affine as jax_conv3x3_affine
from kpvid_tpu.ops.pallas_conv import fold_bn as jax_fold_bn
from kpvid_tpu.ops.pallas_conv import up2_conv3_affine as jax_up2_conv3_affine
from kpvid_tpu.ops.pallas_kernels import gaussian_render_pallas, pose_head_pallas
from kpvid_tpu.ops.resize import up2_conv3 as jax_up2_conv3
from kpvid_tpu_torch import ops
from kpvid_tpu_torch.ops import _build


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _conv_args(rng, n, h, w, c, cout):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, cout)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (cout,)).astype(np.float32)
    shift = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, k, scale, shift


@pytest.mark.parametrize(
    "shape,relu",
    [((2, 16, 16, 8, 8), True), ((2, 16, 8, 8, 16), True), ((2, 8, 8, 16, 8), False),
     ((2, 16, 16, 8, 4), False)],
    ids=["square", "rect", "no_relu", "head_cout4"],
)
def test_conv3x3_plain_matches_pallas(rng, shape, relu):
    x, k, s, t = _conv_args(rng, *shape)
    want = jax_conv3x3_affine(x, k, s, t, relu=relu, interpret=True)
    got = ops.conv3x3_affine(_t(x), _t(k), _t(s), _t(t), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "shape,relu", [((2, 8, 8, 16, 8), True), ((1, 8, 8, 8, 16), False), ((2, 8, 8, 8, 4), False)],
    ids=["relu", "no_relu", "cout4"],
)
def test_up2_conv3_plain_matches_pallas(rng, shape, relu):
    """Exact on all borders: the plain version materializes the edge-clamped
    upsample, the Pallas kernel splices its border lines from XLA."""
    x, k, s, t = _conv_args(rng, *shape)
    want = jax_up2_conv3_affine(x, k, s, t, relu=relu, interpret=True)
    got = ops.up2_conv3_affine(_t(x), _t(k), _t(s), _t(t), relu=relu)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_fold_bn_matches(rng):
    args = [rng.normal(size=(6,)).astype(np.float32) for _ in range(4)]
    var = rng.uniform(0.5, 2.0, (6,)).astype(np.float32)
    for bias in (args[0], None):
        want = jax_fold_bn(bias, *args[1:], var)
        got = ops.fold_bn(None if bias is None else _t(bias), *map(_t, args[1:]), _t(var))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_upsample2x_and_up2_conv3_match(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ops.upsample2x(_t(x)).numpy(), np.asarray(jax_upsample2x(jnp.asarray(x))), rtol=0, atol=0
    )
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    np.testing.assert_allclose(
        ops.up2_conv3(_t(x), _t(k), _t(b)).numpy(), np.asarray(jax_up2_conv3(x, k, b)),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("shape", [(2, 32, 24, 8), (2, 16, 16, 8)])
def test_pose_head_plain_matches_pallas(rng, shape):
    raw = rng.normal(size=shape).astype(np.float32)
    want = pose_head_pallas(jnp.asarray(raw), interpret=True)
    got = ops.pose_head(_t(raw))
    assert got.shape == (shape[0], shape[3], 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_heatmaps_to_keypoints(jnp.asarray(raw))),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("mu_shape,hw", [((3, 8, 2), (32, 16)), ((2, 8, 2), (8, 16))])
def test_gaussian_render_plain_matches_pallas(rng, mu_shape, hw):
    mu = rng.uniform(-1, 1, mu_shape).astype(np.float32)
    want = gaussian_render_pallas(jnp.asarray(mu), *hw, interpret=True)
    got = ops.gaussian_render(_t(mu), *hw)
    assert got.shape == (mu_shape[0], *hw, mu_shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_render_then_pose_head_round_trip_matches_pallas(rng):
    """Peaked maps from the renderer give back their keypoints through the
    soft-argmax, as the Pallas pair does on the same input."""
    mu = rng.uniform(-0.6, 0.6, (1, 4, 2)).astype(np.float32)
    want = pose_head_pallas(gaussian_render_pallas(jnp.asarray(mu), 64, 64, interpret=True)
                            * 2000.0, interpret=True)
    got = ops.pose_head(ops.gaussian_render(_t(mu), 64, 64) * 2000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), mu, atol=0.02)


def test_render_gaussian_maps_batch_dims(rng):
    mu = rng.uniform(-1, 1, (2, 3, 5, 2)).astype(np.float32)
    want = jax_render_gaussian_maps(jnp.asarray(mu), 8, 8)
    got = ops.render_gaussian_maps(_t(mu), 8, 8)
    assert got.shape == (2, 3, 8, 8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_blend(rng):
    bg, crude, mask = (_t(rng.uniform(-1, 1, (2, 4, 4, 3))) for _ in range(3))
    np.testing.assert_allclose(
        ops.blend(bg, crude, mask).numpy(), (bg * mask + crude * (1 - mask)).numpy()
    )


def test_cpu_tensors_take_plain_versions_and_count_nothing(rng):
    ops.reset_launch_counts()
    x, k, s, t = (_t(a) for a in _conv_args(rng, 1, 8, 8, 4, 4))
    torch.testing.assert_close(ops.conv3x3_affine(x, k, s, t), ops.conv3x3_affine_plain(x, k, s, t))
    torch.testing.assert_close(
        ops.up2_conv3_affine(x, k, s, t), ops.up2_conv3_affine_plain(x, k, s, t)
    )
    ops.pose_head(x)
    ops.gaussian_render(torch.zeros(1, 4, 2), 8, 8)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_kernel_wrappers_refuse_other_devices():
    """Only a CPU tensor selects the plain version; any other device must be
    CUDA, and the kernel path refuses what it does not take."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    k = torch.empty(3, 3, 4, 4, device="meta")
    s = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.conv3x3_affine(x, k, s, s)
    with pytest.raises(ValueError, match="CUDA"):
        ops.up2_conv3_affine(x, k, s, s)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pose_head(x)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gaussian_render(torch.empty(1, 4, 2, device="meta"), 8, 8)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """The build raises where there is no CUDA compiler, and caches by the
    source's hash in the build directory it is given."""
    monkeypatch.setenv("KPVID_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has a CUDA toolkit")
    target = _build._target("conv3x3.cu")
    assert target.parent == tmp_path and target.suffix == ".so"
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
