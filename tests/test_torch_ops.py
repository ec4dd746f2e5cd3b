"""kpvid_tpu_torch ops against kpvid_tpu's, on the CPU.

Each kernel wrapper of the port takes its plain PyTorch version for a CPU
tensor; these tests hold those plain versions against the JAX package's
Pallas kernels run in interpret mode, and the plain ops against their jnp
counterparts; the gradients the plain soft-argmax and render take under
torch autograd against ``jax.vjp`` of the jnp forms, which is what JAX's
stage-1 training differentiates. Inputs come from numpy seeds; everything
is float32 except the bfloat16 Gaussian-render and bf16-maps checks.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kpvid_tpu.ops import heatmaps_to_keypoints as jax_heatmaps_to_keypoints
from kpvid_tpu.ops import render_gaussian_maps as jax_render_gaussian_maps
from kpvid_tpu.ops import upsample2x as jax_upsample2x
from kpvid_tpu.ops.pallas_conv import conv3x3_affine as jax_conv3x3_affine
from kpvid_tpu.ops.pallas_conv import fold_bn as jax_fold_bn
from kpvid_tpu.ops.pallas_conv import _up2_phase_kbig as jax_up2_phase_kbig
from kpvid_tpu.ops.pallas_conv import up2_conv3_affine as jax_up2_conv3_affine
from kpvid_tpu.ops.pallas_kernels import gaussian_render_pallas, pose_head_pallas
from kpvid_tpu.ops.resize import up2_conv3 as jax_up2_conv3
from kpvid_tpu_torch import ops
from kpvid_tpu_torch.ops import _build
from kpvid_tpu_torch.ops.resize import conv3x3_same


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


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("frames", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_add_affine_plain_matches_composition(rng, dtype, frames, relu):
    """#1+'s plain version (its op's CPU implementation) against the
    composition it replaces in the split first conv: conv3x3_same, each
    image's addend row broadcast over its T images, oct0a's BN folded by
    fold_bn (no conv bias), ReLU; C = 40 (the future maps' channels) on a
    ragged 13 x 11 image. Both round the conv once in the working dtype and
    keep the rest in f32."""
    n, h, w, c, cout = 8, 13, 11, 40, 24
    x, k, _, _ = _conv_args(rng, n, h, w, c, cout)
    addend = _t(rng.normal(size=(n // frames, h, w, cout)))
    gamma, beta, mean = (_t(rng.normal(size=(cout,))) for _ in range(3))
    var = _t(rng.uniform(0.5, 2.0, (cout,)))
    scale, shift = ops.fold_bn(None, gamma, beta, mean, var)
    dt = getattr(torch, dtype)
    xt, kt = _t(x).to(dt), _t(k).to(dt)
    got = ops.conv3x3_add_affine(xt, kt, addend, scale, shift, relu=relu)
    pre = conv3x3_same(xt, kt).float() + addend.repeat_interleave(frames, dim=0)
    want = pre * scale + shift
    want = (torch.relu(want) if relu else want).to(dt)
    assert got.dtype == dt and got.shape == (n, h, w, cout)
    torch.testing.assert_close(got, want)


def test_conv3x3_add_affine_refuses_a_ragged_addend(rng):
    x, k, s, t = (_t(a) for a in _conv_args(rng, 6, 8, 8, 4, 16))
    for shape in ((4, 8, 8, 16), (3, 8, 8, 8), (3, 8, 7, 16), (0, 8, 8, 16)):
        with pytest.raises(ValueError, match="addend"):
            ops.conv3x3_add_affine(x, k, torch.zeros(shape), s, t)


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


# The bf16 #2's arithmetic (kpvid_tpu_torch/csrc/conv3x3_mma.cuh, the phase
# form), written out in float64 as its specification. _A[a][e][dy]: how much
# of the conv's tap dy reaches the low-resolution x[i + e] in output phase a.
_A = torch.tensor([[[.5, 0, 0], [.5, 1, .5], [0, 0, .5]], [[0, 0, 0], [1, .5, 0], [0, .5, 1]]],
                  dtype=torch.float64)


def _phase_weights(k):
    """up2_phase_weights_kernel before its one rounding: [a, b, e + 1, f + 1,
    C, F]. K_ab[e][f] = sum A_a[e][dy] A_b[f][dx] k[dy][dx], and the slots
    where that is 0 hold the edge terms: a = 1, e = -1 minus the row term's
    weights; b = 1, f = -1 minus the column term's; (1, 1) at (-1, -1)
    k[+1][+1], the corner."""
    k = k.double()
    kp = torch.einsum("aey,bfx,yxco->abefco", _A, _A, k)
    kp[1, :, 0] = -torch.einsum("bfx,xco->bfco", _A, k[2])
    kp[:, 1, :, 0] = -torch.einsum("aey,yco->aeco", _A, k[:, 2])
    kp[1, 1, 0, 0] = k[2, 2]
    return kp


def _phase_up2_conv3(x, k):
    """conv3x3_SAME(upsample2x(x), k) as the card computes it: x padded with
    -x[0] before and +x[n-1] after on each axis (corners by product); per
    phase (a, b) a 3x3 conv of the padded x with _phase_weights, where phase
    b = 1's taps f = -1 read the column copy (zero but at column W - 1),
    phase a = 1 leaves out its taps e = -1 and adds them, as the row term,
    over the last row alone."""
    x = x.double()
    n, h, w, _ = x.shape
    kp = _phase_weights(k)
    xt = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    xt[:, 1:-1, 0], xt[:, 1:-1, -1] = -x[:, :, 0], x[:, :, -1]
    xt[:, 0], xt[:, -1] = -xt[:, 1], xt[:, -2]
    col = torch.zeros_like(xt[:, :, 1:-1])
    col[:, :, -1] = xt[:, :, -2]
    out = x.new_zeros(n, 2 * h, 2 * w, k.shape[3])
    for a in (0, 1):
        for b in (0, 1):
            # copy f + 1: the padded x's columns from f on, [n, h + 2, w, C]
            copies = [col if b else xt[:, :, :w], xt[:, :, 1:w + 1], xt[:, :, 2:]]
            m = sum(copies[f][:, e:e + h] @ kp[a, b, e, f]
                    for e in range(3) for f in range(3) if not (a and e == 0))
            if a:
                m[:, -1] += sum(copies[f][:, h] @ kp[a, b, 0, f] for f in range(3))
            out[:, a::2, b::2] = m
    return out


@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (2, 3), (5, 2), (7, 5), (8, 8)])
def test_up2_phase_form_is_exact_on_every_border(rng, hw):
    """The phase form equals the materialized upsample and conv
    (ops/resize.py::up2_conv3) in float64, on each border line (output
    rows and columns 0, 2n - 2, 2n - 1, which cross at the corners) and
    inside."""
    h, w = hw
    x = torch.from_numpy(rng.normal(size=(2, h, w, 3)))
    k = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)))
    got, want = _phase_up2_conv3(x, k), ops.up2_conv3(x, k)
    assert got.shape == want.shape == (2, 2 * h, 2 * w, 4)
    for r in sorted({0, 2 * h - 2, 2 * h - 1}):
        torch.testing.assert_close(got[:, r], want[:, r], rtol=1e-12, atol=1e-12)
    for c in sorted({0, 2 * w - 2, 2 * w - 1}):
        torch.testing.assert_close(got[:, :, c], want[:, :, c], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_up2_phase_weights_match_jax_kbig(rng):
    """_phase_weights' interior taps are the JAX reference's
    _up2_phase_kbig, column for column ([3C, 12F]: rows f, C; columns e, a,
    b, F); the slots that hold the edge terms are 0 there."""
    c, f = 5, 3
    k = rng.normal(size=(3, 3, c, f)).astype(np.float32)
    kbig = np.asarray(jax_up2_phase_kbig(jnp.asarray(k)), np.float64)
    jx = torch.from_numpy(kbig).reshape(3, c, 3, 2, 2, f).permute(3, 4, 2, 0, 1, 5)
    kp = _phase_weights(torch.from_numpy(k))
    edge = torch.zeros(2, 2, 3, 3, dtype=torch.bool)
    edge[1, :, 0] = edge[:, 1, :, 0] = True
    torch.testing.assert_close(kp[~edge], jx[~edge], rtol=1e-6, atol=1e-6)
    assert edge.sum() == 11 and not jx[edge].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 24, 8), (2, 16, 16, 8)])
def test_pose_head_plain_matches_pallas(rng, shape, dtype):
    """The raw maps in the compute dtype: both sides widen them to f32 first
    (the TPU kernel in its body), so bf16 input keeps the f32 tolerance."""
    raw = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        raw = raw.astype(ml_dtypes.bfloat16)
    want = pose_head_pallas(jnp.asarray(raw), interpret=True)
    got = ops.pose_head(_t(raw).to(getattr(torch, dtype)))
    assert got.shape == (shape[0], shape[3], 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_heatmaps_to_keypoints(jnp.asarray(raw, jnp.float32))),
        rtol=1e-4, atol=1e-5,
    )


def _within_one_bf16_step(got: torch.Tensor, want) -> bool:
    """|got - want| is at most one bf16 step of the larger magnitude
    (2^-7 of it), or below the smallest normal f32, 2^-126: XLA on the CPU
    flushes subnormal results to zero, torch does not."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return bool(np.all(np.abs(g - w) <= 2.0**-7 * np.maximum(np.abs(g), np.abs(w)) + 2.0**-126))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mu_shape,hw", [((3, 8, 2), (32, 16)), ((2, 8, 2), (8, 16))])
def test_gaussian_render_plain_matches_pallas(rng, mu_shape, hw, out_dtype):
    """f32 maps at rtol 1e-4; maps written in bf16 within one bf16 step (the
    two grids differ in the last f32 bit, which can move a rounding)."""
    mu = rng.uniform(-1, 1, mu_shape).astype(np.float32)
    want = gaussian_render_pallas(jnp.asarray(mu), *hw, dtype=getattr(jnp, out_dtype),
                                  interpret=True)
    got = ops.gaussian_render(_t(mu), *hw, out_dtype=getattr(torch, out_dtype))
    assert got.shape == (mu_shape[0], *hw, mu_shape[1])
    assert got.dtype == getattr(torch, out_dtype)
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    else:
        assert _within_one_bf16_step(got, want)


def test_render_then_pose_head_round_trip_matches_pallas(rng):
    """Peaked maps from the renderer give back their keypoints through the
    soft-argmax, as the Pallas pair does on the same input."""
    mu = rng.uniform(-0.6, 0.6, (1, 4, 2)).astype(np.float32)
    want = pose_head_pallas(gaussian_render_pallas(jnp.asarray(mu), 64, 64, interpret=True)
                            * 2000.0, interpret=True)
    got = ops.pose_head(ops.gaussian_render(_t(mu), 64, 64) * 2000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), mu, atol=0.02)


@pytest.mark.parametrize("size", [8, 32, 33, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_matches_jax_linspace(size, dtype):
    """The grid takes the values of jnp.linspace(-1, 1, size, dtype): exactly
    in bfloat16, within 2.4e-7 in f32 (torch.linspace and jnp.linspace
    round differently)."""
    want = np.asarray(jnp.linspace(-1.0, 1.0, size, dtype=getattr(jnp, dtype)), np.float32)
    got = ops.grid(size, torch.device("cpu"), getattr(torch, dtype))
    assert got.dtype == torch.float32
    atol = 0.0 if dtype == "bfloat16" else 2.0**-22
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_gaussian_render_bf16_matches_jax(rng):
    """bfloat16 keypoints: JAX renders on a bf16 grid with a bf16 inv_std^2;
    the port takes the same grid and c2 and computes in f32. The gap left is
    JAX's bf16 arithmetic, under one bf16 step at the peak (2^-7 = 0.0078).
    An f32 grid, as the port had before, misses by 0.07."""
    mu = rng.uniform(-1, 1, (256, 40, 2)).astype(ml_dtypes.bfloat16)
    want = np.asarray(jax_render_gaussian_maps(jnp.asarray(mu), 32, 32, 14.3), np.float32)
    mu_t = torch.from_numpy(mu.astype(np.float32)).to(torch.bfloat16)
    got = ops.gaussian_render(mu_t, 32, 32, 14.3, grid_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 0.008
    f32_grid = ops.render_gaussian_maps(mu_t, 32, 32, 14.3).numpy()
    assert np.abs(f32_grid - want).max() > 0.03


def test_render_gaussian_maps_batch_dims(rng):
    mu = rng.uniform(-1, 1, (2, 3, 5, 2)).astype(np.float32)
    want = jax_render_gaussian_maps(jnp.asarray(mu), 8, 8)
    got = ops.render_gaussian_maps(_t(mu), 8, 8)
    assert got.shape == (2, 3, 8, 8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _vjp_of_soft_argmax(raw, g):
    """JAX's gradient of the maps through heatmaps_to_keypoints(raw.astype(f32)),
    as PoseEncoder differentiates it, in the maps' dtype."""
    _, vjp = jax.vjp(lambda r: jax_heatmaps_to_keypoints(r.astype(jnp.float32)), jnp.asarray(raw))
    return np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 24, 8), (3, 16, 16, 5)])
def test_soft_argmax_grad_matches_jax(rng, shape, dtype):
    """The maps' gradient of the plain soft-argmax under torch autograd, the
    CPU side of the pose_head kernel's backward: f32 within atol 1e-6 of
    JAX's; bf16 maps get a bf16 gradient (the f32 gradient rounded once, as
    the VJP of astype(f32) rounds it) within one bf16 step."""
    raw = (3 * rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=(shape[0], shape[3], 2)).astype(np.float32)
    if dtype == "bfloat16":
        raw = raw.astype(ml_dtypes.bfloat16)
    want = _vjp_of_soft_argmax(raw, g)
    raw_t = _t(raw).to(getattr(torch, dtype)).requires_grad_()
    (got,) = torch.autograd.grad(ops.pose_head(raw_t), raw_t, _t(g))
    assert got.dtype == raw_t.dtype and got.shape == raw_t.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        assert _within_one_bf16_step(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mu_shape,hw", [((3, 8, 2), (32, 32)), ((2, 5, 2), (8, 16))])
def test_render_grad_matches_jax(rng, mu_shape, hw, out_dtype):
    """The points' gradient of the plain render under torch autograd, the
    CPU side of the gaussian_render kernel's backward, against JAX's VJP of
    render_gaussian_maps(mu).astype(out_dtype) on the f32 grid, as the
    stage-1 forward renders: the cotangent in ``out_dtype`` widened to f32.
    Within 1e-5 of the largest |gradient|: each point's gradient sums terms
    up to 2 inv_std^2 = 409 times the unit cotangent that cancel to a tenth
    of that, so f32 reassociation alone moves it by a few 1e-6 of its max
    (atol 1e-6 is below one f32 step of these values)."""
    mu = rng.uniform(-1, 1, mu_shape).astype(np.float32)
    ct = rng.normal(size=(mu_shape[0], *hw, mu_shape[1])).astype(np.float32)
    jdt = getattr(jnp, out_dtype)
    ct = np.asarray(jnp.asarray(ct).astype(jdt).astype(jnp.float32))
    _, vjp = jax.vjp(lambda m: jax_render_gaussian_maps(m, *hw, 14.3).astype(jdt), jnp.asarray(mu))
    want = np.asarray(vjp(jnp.asarray(ct).astype(jdt))[0])
    mu_t = _t(mu).requires_grad_()
    maps = ops.gaussian_render(mu_t, *hw, 14.3, out_dtype=getattr(torch, out_dtype))
    (got,) = torch.autograd.grad(maps, mu_t, _t(ct).to(maps.dtype))
    assert got.dtype == torch.float32 and got.shape == mu_t.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


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
    add = torch.ones(1, 8, 8, 4)
    torch.testing.assert_close(ops.conv3x3_add_affine(x, k, add, s, t),
                               ops.conv3x3_add_affine_plain(x, k, add, s, t))
    ops.pose_head(x)
    ops.gaussian_render(torch.zeros(1, 4, 2), 8, 8)
    raw = x.clone().requires_grad_()
    pts = torch.zeros(1, 4, 2, requires_grad=True)
    torch.autograd.grad(ops.pose_head(raw).sum() + ops.gaussian_render(pts, 8, 8).sum(),
                        [raw, pts])
    mu = torch.rand(2, 4, 2) * 2 - 1
    torch.testing.assert_close(
        ops.gaussian_render(mu, 8, 8, grid_dtype=torch.bfloat16),
        ops.render_gaussian_maps(mu, 8, 8, grid_dtype=torch.bfloat16),
    )
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_kernel_wrappers_refuse_other_devices():
    """Only a CPU tensor selects the plain version; any other device must be
    CUDA: the kernels' launchers (the ops' CUDA implementations) refuse a
    tensor elsewhere. A meta tensor reaches the ops' fake implementations,
    which give shapes and dtypes and launch nothing."""
    from kpvid_tpu_torch.ops import conv3x3, keypoint_kernels

    x = torch.empty(1, 8, 8, 4, device="meta")
    k = torch.empty(3, 3, 4, 4, device="meta")
    s = torch.empty(4, device="meta")
    pts = torch.empty(1, 4, 2, device="meta")
    p = torch.empty(1, 4, 8, device="meta")
    for up2 in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            conv3x3.launch(x, k, s, s, True, up2)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.launch(x, k, s, s, True, False, addend=x)
    for marginals in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            keypoint_kernels.pose_head_launch(x, marginals)
    with pytest.raises(ValueError, match="CUDA"):
        keypoint_kernels.render_launch(pts, 8, 8, 14.3, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        keypoint_kernels.pose_head_backward_launch(pts, pts, p, p, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        keypoint_kernels.render_backward_launch(x, pts, 14.3, torch.float32)
    ops.reset_launch_counts()
    for out, shape, dtype in (
        (ops.conv3x3_affine(x, k, s, s), (1, 8, 8, 4), torch.float32),
        (ops.up2_conv3_affine(x, k, s, s), (1, 16, 16, 4), torch.float32),
        (ops.conv3x3_add_affine(x, k, x, s, s), (1, 8, 8, 4), torch.float32),
        (ops.pose_head(x), (1, 4, 2), torch.float32),
        (ops.gaussian_render(pts, 8, 6, out_dtype=torch.bfloat16), (1, 8, 6, 4), torch.bfloat16),
        (ops.pose_head_backward(pts, pts, p, p, torch.bfloat16), (1, 8, 8, 4), torch.bfloat16),
        (ops.gaussian_render_backward(x, pts), (1, 4, 2), torch.float32),
    ):
        assert out.device.type == "meta" and tuple(out.shape) == shape and out.dtype == dtype
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


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


def test_build_key_covers_headers(monkeypatch, tmp_path):
    """An edited header, the source or the flags give another library name,
    so the next use rebuilds; an unrelated file in csrc does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("KPVID_TORCH_BUILD_DIR", str(tmp_path / "build"))
    first = _build._target("k.cu")
    assert first == _build._target("k.cu")
    (csrc / "notes.txt").write_text("not a source\n")
    assert _build._target("k.cu") == first
    (csrc / "k.cuh").write_text("// v2\n")
    second = _build._target("k.cu")
    assert second != first and second.parent == first.parent
    (csrc / "k.cu").write_text('#include "k.cuh"\n// edited\n')
    assert _build._target("k.cu") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target("k.cu") not in (first, second)


def test_build_and_load_are_safe_under_threads(monkeypatch, tmp_path):
    """Many threads loading both libraries at once, with nvcc stubbed: each
    source is compiled once, every thread gets the one loaded library, and
    each compile writes to a temporary name that carries the process and
    the thread before it is renamed into place."""
    import os
    import sys
    import threading
    import time

    monkeypatch.setenv("KPVID_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_libs", {})
    compiles = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            self.out = cmd[cmd.index("-o") + 1]
            compiles.append((cmd[-1], self.out, threading.get_ident()))

        def communicate(self):
            time.sleep(0.01)
            _build.Path(self.out).write_bytes(b"\x7fELF")
            return "ptxas info: stub", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    got, errors = [], []

    def worker(i):
        try:
            src = _build.SOURCES[i % 2]
            assert _build._target(src).parent == tmp_path
            got.append((src, _build.load(src)))
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(src.rsplit("/", 1)[-1] for src, _, _ in compiles) == sorted(_build.SOURCES)
    for _, tmp, ident in compiles:
        assert tmp.endswith(f".{os.getpid()}.{ident}.tmp")
    assert len(got) == 32
    for src in _build.SOURCES:
        libs = {lib for s, lib in got if s == src}
        assert libs == {("lib", str(_build._target(src)))}
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".so", ".so"]
    assert _build.build_all() >= 0.0 and len(compiles) == 2  # cached: nothing to compile
