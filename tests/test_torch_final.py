"""The port's generation slice against kpvid_tpu's, on the CPU.

FinalGenerator.generate with an explicit z and InferenceEngine.run of
kpvid_tpu_torch against the JAX package's, at the smoke widths of
tests/test_final.py in f32, with every BN statistic, BN affine and bias of
the JAX variables drawn at random before the same trees go through the
bridge. The JAX reference is its default configuration (XLA convs); JAX's
own slow test holds that equal to the Pallas chain the port's kernels
replace. One test repeats the generation in bfloat16.
"""

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.configs import Config, ModelConfig, TrainingConfig
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator
from kpvid_tpu.eval.server import InferenceEngine as JaxInferenceEngine
from kpvid_tpu.eval.server import device_quantize as jax_device_quantize
from kpvid_tpu.eval.server import request_z as jax_request_z
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch.configs import Config as TConfig
from kpvid_tpu_torch.configs import ModelConfig as TModelConfig
from kpvid_tpu_torch.configs import TrainingConfig as TTrainingConfig
from kpvid_tpu_torch.eval import (
    FinalGenerator,
    InferenceEngine,
    device_quantize,
    request_z,
    to_uint8,
)

SMOKE = dict(
    n_pts=4, n_action=5, cell_info=(16, 16), vae_dim=8, image_size=32, heatmap_size=8,
    n_future_frames=6, encoder_filters=8, translator_filters=16, pose_decoder_filters=16,
    discriminator_filters=8,
)


def randomize(tree, rng):
    """Every BN statistic, BN scale and bias of a Flax tree drawn at random."""
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = randomize(val, rng)
            continue
        a = np.asarray(val, np.float32)
        if key == "var":
            a = rng.uniform(0.5, 2.0, a.shape)
        elif key == "scale":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif key in ("mean", "bias"):
            a = rng.normal(0.0, 0.1, a.shape)
        out[key] = a.astype(np.float32)
    return out


def _setup(dtype: str):
    cfg = Config(
        model=ModelConfig(**SMOKE), training=TrainingConfig(batch_size=2, compute_dtype=dtype)
    ).validate()
    tcfg = TConfig(model=TModelConfig(**SMOKE), training=TTrainingConfig(dtype)).validate()
    jgen = JaxFinalGenerator(cfg)
    s1, s2 = jgen.init_variables(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    s1 = {"params": randomize(s1["params"], rng), "batch_stats": randomize(s1["batch_stats"], rng)}
    s2p = randomize(s2["params"], rng)
    return cfg, tcfg, jgen, s1, s2p, bridge.from_jax(s1, s2p)


@pytest.fixture(scope="module")
def setup():
    return _setup("float32")


def test_generate_matches_jax(setup):
    """Images, mask and crude at atol 1e-4; keypoints at atol 1e-5."""
    cfg, tcfg, jgen, s1, s2p, params = setup
    rng = np.random.default_rng(11)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[[1, 3]]
    z = rng.standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda a, b, c, d, e: jgen.generate(a, b, c, d, None, z=e))(s1, s2p, im, act, z)
    gen = FinalGenerator(tcfg, device="cpu")
    gen.load_parameters(params)
    got = gen.generate(im, act, z)
    for key, atol in (("current_points", 1e-5), ("future_points", 1e-5), ("pred_im_seq", 1e-4),
                      ("mask", 1e-4), ("pred_im_crude", 1e-4)):
        assert got[key].shape == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol,
                                   err_msg=key)
    assert float(got["mask"].min()) > 0.0 and float(got["mask"].max()) < 1.0


def test_generate_bf16_matches_jax():
    """compute_dtype bfloat16 through both packages, same parameters and z.
    The two round bf16 at other places (the port's conv kernels round once
    after the affine, XLA after the conv and again after BN), so each output
    is held to a bound with room over what that rounding gives:
    - current points (f32 soft-argmax of bf16 heatmaps): atol 1e-4;
    - future points (bf16): one bf16 step of the largest, 2^-8 * max|x|;
    - the future Gaussian maps each renders from its own future points:
      0.008, one bf16 step at the peak, as in the render test of
      test_torch_ops.py;
    - images, crude and mask (in [-1, 1] / [0, 1]): atol 0.02, 2.5 bf16
      steps at 1.0, and a mean error under 0.002."""
    from kpvid_tpu.ops import render_gaussian_maps as jax_render_gaussian_maps
    from kpvid_tpu_torch.ops import gaussian_render

    cfg, tcfg, jgen, s1, s2p, params = _setup("bfloat16")
    rng = np.random.default_rng(11)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[[1, 3]]
    z = rng.standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda a, b, c, d, e: jgen.generate(a, b, c, d, None, z=e))(s1, s2p, im, act, z)
    gen = FinalGenerator(tcfg, device="cpu")
    gen.load_parameters(params)
    got = gen.generate(im, act, z)
    assert got["future_points"].dtype == torch.bfloat16

    def err(key):
        assert got[key].shape == tuple(want[key].shape), key
        return np.abs(got[key].float().numpy() - np.asarray(want[key], np.float32))

    assert err("current_points").max() <= 1e-4
    fut = np.asarray(want["future_points"], np.float32)
    assert err("future_points").max() <= 2.0**-8 * np.abs(fut).max()
    hs, inv_std = cfg.model.heatmap_size, cfg.model.heatmap_inv_std
    want_maps = np.asarray(jax_render_gaussian_maps(want["future_points"], hs, hs, inv_std),
                           np.float32)
    got_maps = gaussian_render(got["future_points"].float(), hs, hs, inv_std,
                               grid_dtype=torch.bfloat16)
    assert np.abs(got_maps.numpy() - want_maps).max() <= 0.008
    for key in ("pred_im_seq", "pred_im_crude", "mask"):
        e = err(key)
        assert e.max() <= 0.02 and e.mean() <= 0.002, (key, e.max(), e.mean())


def test_inference_engine_matches_jax(setup):
    """Same requests, same request seeds: uint8 outputs within one step (a
    float difference at a quantization boundary), points at atol 1e-5."""
    cfg, tcfg, _, s1, s2p, params = setup
    rng = np.random.default_rng(12)
    images = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    actions = np.array([0, 2, 4])
    seeds = (101, 102, 103)
    z = np.stack([request_z(s, 8) for s in seeds])
    np.testing.assert_array_equal(z, np.stack([jax_request_z(s, 8) for s in seeds]))
    want = JaxInferenceEngine(cfg, s1, s2p).run(images, actions, z)
    engine = InferenceEngine(tcfg, params, device="cpu")
    got = engine.run(images, actions, z)
    assert set(got) == set(want) == set(engine.OUTPUT_KEYS)
    for key in ("pred_im_seq", "mask"):
        assert got[key].dtype == np.uint8 and got[key].shape == want[key].shape
        diff = np.abs(got[key].astype(np.int16) - want[key].astype(np.int16))
        assert diff.max() <= 1, key
    for key in ("current_points", "future_points"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    # a request's video depends only on its own (image, action, seed), up to
    # the summation order a matmul picks for another batch size
    one = engine.run(images[1:2], actions[1:2], z[1:2])
    np.testing.assert_allclose(one["future_points"], got["future_points"][1:2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_bit_identical_to_former_casts(dtype):
    """The raw maps go to pose_head in the compute dtype and both Gaussian
    maps are written in it (current maps on the f32 grid, future maps on the
    keypoints' grid). On the CPU that gives the very bits of the former path:
    pose_head on the raw maps widened to f32, the maps rendered in f32 and
    cast with .to(dt) after."""
    from unittest import mock

    from kpvid_tpu_torch.ops import heatmaps_to_keypoints, render_gaussian_maps

    def former_render(mu, h, w, inv_std=14.3, grid_dtype=torch.float32,
                      out_dtype=torch.float32):
        return render_gaussian_maps(mu, h, w, inv_std, grid_dtype).to(out_dtype)

    tcfg = TConfig(model=TModelConfig(**SMOKE), training=TTrainingConfig(dtype)).validate()
    gen = FinalGenerator(tcfg, device="cpu")
    params = gen.init_parameters(0)
    g = torch.Generator().manual_seed(3)
    for key, val in params.items():
        if key.endswith("running_var"):
            val.uniform_(0.5, 2.0, generator=g)
        elif key.endswith(".bn.weight"):
            val.uniform_(0.5, 1.5, generator=g)
        elif key.endswith(("running_mean", "bias")):
            val.normal_(0.0, 0.1, generator=g)
    gen.load_parameters(params)
    rng = np.random.default_rng(13)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[[0, 4]]
    z = rng.standard_normal((2, 8)).astype(np.float32)
    got = gen.generate(im, act, z)
    with mock.patch("kpvid_tpu_torch.models.networks.pose_head",
                    lambda raw: heatmaps_to_keypoints(raw.float().contiguous())), \
            mock.patch("kpvid_tpu_torch.eval.final.gaussian_render", former_render):
        want = gen.generate(im, act, z)
    for key in ("current_points", "future_points", "pred_im_seq", "mask", "pred_im_crude"):
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_quantization_matches_jax():
    x = np.linspace(-1.2, 1.2, 1001, dtype=np.float32)
    for rescale in (True, False):
        want = np.asarray(jax_device_quantize(x, rescale=rescale))
        np.testing.assert_array_equal(device_quantize(torch.from_numpy(x), rescale).numpy(), want)
        np.testing.assert_array_equal(to_uint8(x, rescale), want)


def test_entry_points_default_to_the_card(setup):
    """Without a CUDA device the entry points raise rather than run on the CPU."""
    _, tcfg, *_, params = setup
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        FinalGenerator(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tcfg, params)
