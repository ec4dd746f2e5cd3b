"""kpvid_tpu_torch networks against Flax ``apply``, on the CPU.

The JAX variables are initialized at the smoke widths of tests/test_final.py,
then every BN statistic, BN affine and bias is drawn at random (init values
of 0 and 1 would hide a mistake in any of them), and the same trees go
through the bridge into the port. Inputs come from numpy seeds; f32
throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kpvid_tpu.configs import Config, ModelConfig, TrainingConfig
from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator
from kpvid_tpu.models.networks import ConvEncoder as JaxConvEncoder
from kpvid_tpu.models.networks import PoseEncoder as JaxPoseEncoder
from kpvid_tpu.models.networks import Translator as JaxTranslator
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch.configs import Config as TConfig
from kpvid_tpu_torch.configs import ModelConfig as TModelConfig
from kpvid_tpu_torch.configs import TrainingConfig as TTrainingConfig
from kpvid_tpu_torch.configs import load_config
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.models import ConvEncoder, PoseEncoder
from kpvid_tpu_torch.ops import conv3x3_add_affine, translator_chain
from kpvid_tpu_torch.ops.resize import conv3x3_same

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
    rng = np.random.default_rng(5)
    s1 = {"params": randomize(s1["params"], rng), "batch_stats": randomize(s1["batch_stats"], rng)}
    s2p = randomize(s2["params"], rng)
    gen = FinalGenerator(tcfg, device="cpu")
    gen.load_parameters(bridge.from_jax(s1, s2p))
    return jgen, s1, s2p, gen


def _im(rng, b=2, s=32):
    return rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


def test_conv_encoder_matches_flax():
    """Standalone trunk, bridged; covers the asymmetric TF SAME padding of the
    stride-2 convs at even and odd sizes."""
    rng = np.random.default_rng(0)
    mod = JaxConvEncoder(filters=4)
    for size in (16, 13):
        x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        v = jax.jit(lambda r: mod.init(r, x, train=False))(jax.random.PRNGKey(1))
        v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng)}
        want = jax.jit(lambda v, x: mod.apply(v, x, train=False))(v, x)
        enc = ConvEncoder(3, 4)
        state = {
            bridge.torch_name(p): bridge._convert(a)
            for col in ("params", "batch_stats") for p, a in bridge._flatten(v[col])
        }
        enc.load_state_dict(state, strict=True)
        got = enc(torch.from_numpy(x))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_image_encoder_embed_matches_flax(setup):
    jgen, s1, _, gen = setup
    im = _im(np.random.default_rng(1))
    want = jax.jit(lambda v, im: jgen.stage1.apply(v, im, method=jgen.stage1.embed))(s1, im)
    with torch.no_grad():
        got = gen.stage1.embed(torch.from_numpy(im))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["fused", "tf1"])
def test_pose_encoder_detect_matches_flax(setup, mode):
    """Both JAX upsample forms of the skip decoder (the generation path's
    'fused' and training's 'tf1') against the port's one; keypoints in f32."""
    _, s1, _, gen = setup
    im = _im(np.random.default_rng(2))
    mod = JaxPoseEncoder(4, filters=16, trunk_filters=8, upsample_mode=mode)
    v = {"params": s1["params"]["pose_encoder"], "batch_stats": s1["batch_stats"]["pose_encoder"]}
    want_mu, want_raw = jax.jit(
        lambda v, im: mod.apply(v, im, train=False, return_raw_maps=True)
    )(v, im)
    with torch.no_grad():
        raw = gen.stage1.pose_encoder.raw_maps(torch.from_numpy(im))
        mu = gen.stage1.detect(torch.from_numpy(im))
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), rtol=1e-4, atol=1e-5)
    assert mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), rtol=1e-4, atol=1e-5)


def test_translator_chain_matches_flax(setup):
    """The port's serving decode (ops/chain.py on ``serving_weights()``,
    plain versions on the CPU) against the Flax Translator with
    precomputed_first + fused_heads. The port's chain starts at oct0b from
    oct0a's activation, which #1+'s plain version computes as the split
    first conv does: a conv of per-frame maps plus one addend for all 3
    frames, the record's folded oct0a BN, ReLU. Flax is handed the same conv
    + addend as its precomputed_first. The record's head kernel is Flax's
    concatenation exactly."""
    _, s1, _, gen = setup
    rng = np.random.default_rng(3)
    maps = torch.from_numpy(rng.normal(size=(3, 8, 8, 5)).astype(np.float32))
    kernel = torch.from_numpy((rng.normal(size=(3, 3, 5, 16)) * 0.2).astype(np.float32))
    addend = torch.from_numpy(rng.normal(size=(1, 8, 8, 16)).astype(np.float32))
    first = (conv3x3_same(maps, kernel) + addend).numpy()
    tp = s1["params"]["translator"]
    hk = np.concatenate([tp["crude"]["Conv_0"]["kernel"], tp["mask"]["Conv_0"]["kernel"]], -1)
    hb = np.concatenate([tp["crude"]["Conv_0"]["bias"], tp["mask"]["Conv_0"]["bias"]], 0)
    tv = {"params": tp, "batch_stats": s1["batch_stats"]["translator"]}
    mod = JaxTranslator(filters=16, upsample_mode="fused")
    want_crude, want_mask = jax.jit(
        lambda tv, x: mod.apply(tv, x, False, precomputed_first=x, fused_heads=(hk, hb))
    )(tv, jnp.asarray(first))
    with torch.no_grad():
        w = gen.stage1.translator.serving_weights()
        np.testing.assert_allclose(w.head.kernel.numpy(), hk, rtol=0, atol=0)
        np.testing.assert_allclose(w.head.bias.numpy(), hb, rtol=0, atol=0)
        act = conv3x3_add_affine(maps, kernel, addend, w.first.scale, w.first.shift)
        crude, mask = translator_chain(act, w)
    assert crude.shape == (3, 32, 32, 3) and mask.shape == (3, 32, 32, 1)
    np.testing.assert_allclose(crude.numpy(), np.asarray(want_crude), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mask.numpy(), np.asarray(want_mask), rtol=1e-4, atol=1e-5)


def test_motion_decode_matches_flax(setup):
    jgen, _, s2p, gen = setup
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, 8)).astype(np.float32)
    first_pt = rng.uniform(-1, 1, (2, 8)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[[0, 3]]
    want = jax.jit(
        lambda p, *a: jgen.stage2.apply({"params": p}, *a, method=jgen.stage2.decode)
    )(s2p, z, first_pt, act)
    with torch.no_grad():
        got = gen.stage2.decode(*map(torch.from_numpy, (z, first_pt, act)))
    assert got.shape == (2, 6, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_bridge_covers_every_parameter(setup):
    """The bridge fills every port parameter (strict load), keeps the LSTM
    and Dense layouts and turns conv kernels from HWIO to OIHW."""
    _, s1, s2p, gen = setup
    params = bridge.from_jax(s1, s2p)
    assert set(params) == set(gen.model.state_dict())
    k = s1["params"]["translator"]["oct0b_conv"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        params["stage1.translator.oct0b.conv.weight"].numpy(), k.transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(
        params["stage2.dec_lstm.lstm_1_kernel"].numpy(), s2p["dec_lstm"]["lstm_1_kernel"]
    )
    np.testing.assert_array_equal(
        params["stage1.pose_encoder.trunk.in0.bn.running_var"].numpy(),
        s1["batch_stats"]["pose_encoder"]["trunk"]["in0_bn"]["BatchNorm_0"]["var"],
    )


def test_init_parameters_match_jax_init_laws(setup):
    """Same keys and shapes as the bridged JAX init, and the same laws:
    Xavier-uniform bounds, zero biases, BN 1/0/0/1, normal(0.02) to_coord."""
    jgen, _, _, gen = setup
    s1, s2 = jgen.init_variables(jax.random.PRNGKey(3))
    ref = bridge.from_jax(s1, s2["params"])
    got = gen.init_parameters(7)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    for key, val in got.items():
        if key.endswith(("bias", "running_mean", "running_var", ".bn.weight")):
            torch.testing.assert_close(val, ref[key])
        elif key.endswith("to_coord.weight"):
            assert abs(float(val.std()) - 0.02) < 0.005
        else:  # Xavier-uniform
            rf = int(np.prod(val.shape[2:]))
            fan_in, fan_out = (val.shape[1] * rf, val.shape[0] * rf) if val.dim() == 4 else val.shape
            bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
            assert float(val.abs().max()) <= bound
            assert float(ref[key].abs().max()) <= bound * (1 + 1e-6)
            if val.numel() >= 256:
                assert abs(float(val.std()) / (bound / np.sqrt(3.0)) - 1.0) < 0.15, key
    assert torch.equal(got["stage1.translator.oct0a.conv.weight"],
                       gen.init_parameters(7)["stage1.translator.oct0a.conv.weight"])


def test_config_copy_matches_jax():
    """The port's YAML loader reads the same smoke file the same way, and its
    defaults are the JAX package's."""
    jcfg = jax_load_config("kpvid_tpu/configs/smoke.yaml")
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    for f in TModelConfig.__dataclass_fields__:
        assert getattr(cfg.model, f) == getattr(jcfg.model, f), f
        assert getattr(TModelConfig(), f) == getattr(ModelConfig(), f), f
    assert cfg.training.compute_dtype == jcfg.training.compute_dtype == "float32"
    assert load_config("kpvid_tpu/configs/penn.yaml").model == TModelConfig(
        **{f: getattr(jax_load_config("kpvid_tpu/configs/penn.yaml").model, f)
           for f in TModelConfig.__dataclass_fields__}
    )
    with pytest.raises(ValueError, match="4 \\* heatmap_size"):
        TConfig(model=TModelConfig(image_size=64)).validate()
    with pytest.raises(ValueError, match="compute_dtype"):
        TConfig(training=TTrainingConfig("float16")).validate()


def test_config_paths_and_data_match_jax(tmp_path):
    """paths.data_dir and every data field the port reads: the JAX defaults,
    the same values from the same files, the same refusal of a bad
    native_ops; a key the port does not read is accepted."""
    from kpvid_tpu.configs.config import Config as JaxConfig
    from kpvid_tpu_torch.configs import DataConfig, PathsConfig

    for path in ("kpvid_tpu/configs/smoke.yaml", "kpvid_tpu/configs/penn.yaml"):
        jcfg, cfg = jax_load_config(path), load_config(path)
        assert cfg.paths.data_dir == jcfg.paths.data_dir
        for f in DataConfig.__dataclass_fields__:
            assert getattr(cfg.data, f) == getattr(jcfg.data, f), f
    assert PathsConfig().data_dir == JaxConfig().paths.data_dir
    for f in DataConfig.__dataclass_fields__:
        assert getattr(DataConfig(), f) == getattr(JaxConfig().data, f), f
    bad = tmp_path / "bad.yaml"
    bad.write_text("data: {native_ops: maybe, num_workers: 3}\npaths: {log_dir: x}\n")
    with pytest.raises(ValueError) as jerr:
        jax_load_config(bad)
    with pytest.raises(ValueError) as err:
        load_config(bad)
    assert str(err.value) == str(jerr.value) == "data.native_ops must be auto|on|off, got 'maybe'"
    # decode_cache_mb is read (stage 1's frame cache); min_image_seq_len is not
    bad.write_text("data: {native_ops: 'on', labeler_chunk: 64, decode_cache_mb: 8, "
                   "min_image_seq_len: 99}\n")
    assert load_config(bad).data == DataConfig(native_ops="on", labeler_chunk=64,
                                               decode_cache_mb=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_lstm_matches_flax(dtype):
    """StackedLSTM at features (256, 256), B = 8, T = 32, D = 32, Xavier
    kernels, random biases. bf16: the gates are f32 products of the
    bf16-rounded input and kernel, as JAX's preferred_element_type=f32 dot;
    rounding the gates to bf16 (the fault) gave max 5.9e-4, mean 7.0e-5. The
    bound holds the mean 10x under that: max 2e-4, mean 7e-6. f32: 1e-6."""
    from kpvid_tpu.models.layers import StackedLSTM as JaxStackedLSTM
    from kpvid_tpu_torch.models import StackedLSTM

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    mod = JaxStackedLSTM((256, 256), dtype=getattr(jnp, dtype))
    params = jax.tree.map(np.asarray, jax.jit(lambda r: mod.init(r, xs))(jax.random.PRNGKey(0))
                          ["params"])
    for key in params:
        if "bias" in key:
            params[key] = rng.normal(0, 0.1, params[key].shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: mod.apply({"params": p}, x))(params, xs))
    lstm = StackedLSTM(32, (256, 256), getattr(torch, dtype))
    lstm.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, strict=True)
    with torch.no_grad():
        got = lstm(torch.from_numpy(xs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert err.max() <= 1e-6
    else:
        assert err.max() <= 2e-4 and err.mean() <= 7e-6, (err.max(), err.mean())
