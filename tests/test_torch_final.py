"""The port's generation slice against kpvid_tpu's, on the CPU.

FinalGenerator.generate with an explicit z and InferenceEngine.run of
kpvid_tpu_torch against the JAX package's, at the smoke widths of
tests/test_final.py in f32, with every BN statistic, BN affine and bias of
the JAX variables drawn at random before the same trees go through the
bridge. The JAX reference is its default configuration (XLA convs); JAX's
own slow test holds that equal to the Pallas chain the port's kernels
replace.
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


@pytest.fixture(scope="module")
def setup():
    cfg = Config(
        model=ModelConfig(**SMOKE), training=TrainingConfig(batch_size=2, compute_dtype="float32")
    ).validate()
    tcfg = TConfig(model=TModelConfig(**SMOKE), training=TTrainingConfig("float32")).validate()
    jgen = JaxFinalGenerator(cfg)
    s1, s2 = jgen.init_variables(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    s1 = {"params": randomize(s1["params"], rng), "batch_stats": randomize(s1["batch_stats"], rng)}
    s2p = randomize(s2["params"], rng)
    return cfg, tcfg, jgen, s1, s2p, bridge.from_jax(s1, s2p)


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
