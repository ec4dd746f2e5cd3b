"""The port's stage-1 trainer against kpvid_tpu's, on the CPU, in f32.

Smoke widths: K = 4, 32^2 images, 8^2 maps, encoder 8, translator 16, pose
decoder 16, PatchGAN 8, batch 2, and the synthesized VGG19 clamped to 16
channels on both sides. The JAX trainer initializes both networks, then
every BN statistic, BN affine and bias is drawn at random; the bridge
carries the same trees into the port. Batches come from numpy seeds.

Tolerances: metrics rtol 1e-4 (f32, float reassociation only); BN running
statistics atol 1e-5; parameters after the steps atol 2e-6 (the updates
are lr = 1e-4 in size), except where Adam's first update is a sign step: an
element whose first-step gradient is below 1e-6 in magnitude may differ by
up to 2.5 * lr per step taken, since lr * g / (|g| + 1e-8) turns a tiny
difference in g into a different step (and with b1 = 0.5 a later step of
such an element reaches 1.14 lr: |m_hat| / sqrt(v_hat) <= 1.14 over three
steps). The bias of a conv that feeds a
train-mode BN, and the heat map's bias (the soft-argmax does not see a
constant added to a map), are such elements whatever their gradient's size:
their gradient is zero in exact arithmetic and what each side computes is
its own rounding. After the first step, up to 2% of a tensor's elements may
differ by up to 2e-6 + lr / 2 per later step: the perceptual loss is an L1
of ReLU features, whose gradient flips sign where a feature of the
prediction crosses its target's or zero, so forwards that agree to 1e-5
give gradients that differ by up to 0.5% of their max (the gradient of the
loss in the prediction itself agrees to 4e-7 from the same prediction), and
Adam's later steps turn that into differences up to 0.3 lr where an
element's gradient changes sign (127 of 403k elements over 3 fused steps).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.configs import Config, ModelConfig, TrainingConfig
from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu.data import ImagePairDataset as JaxImagePairDataset
from kpvid_tpu.eval.visualize import stage1_summary_images as jax_stage1_summary_images
from kpvid_tpu.losses import perceptual_loss as jax_perceptual_loss
from kpvid_tpu.losses import synthesize_vgg19_params as jax_synthesize_vgg19_params
from kpvid_tpu.models.layers import BatchNorm as JaxBatchNorm
from kpvid_tpu.models.networks import ImageDiscriminator as JaxImageDiscriminator
from kpvid_tpu.train.stage1 import Stage1Trainer as JaxStage1Trainer
from kpvid_tpu.utils import get_n_colors as jax_get_n_colors
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.losses import (
    load_vgg19_params,
    perceptual_loss,
    prepare_vgg19,
    synthesize_vgg19_params,
)
from kpvid_tpu_torch.models import BatchNorm, ImageDiscriminator, updating_batch_stats
from kpvid_tpu_torch.train import Stage1Trainer
from kpvid_tpu_torch.utils import get_n_colors

SMOKE1 = dict(n_pts=4, image_size=32, heatmap_size=8, encoder_filters=8, translator_filters=16,
              pose_decoder_filters=16, discriminator_filters=8)
B = 2
LR = 1e-4
PARAM_ATOL = 2e-6
STATS_ATOL = 1e-5
METRIC_RTOL = 1e-4
VGG_WIDTH = 16
# the image encoder's last octave feeds nothing of stage 1 (the translator
# takes the 1/4-resolution features): zero gradients on both sides
UNUSED = ("stage1.image_encoder.trunk.down2.", "stage1.image_encoder.trunk.keep2.")


def jax_config(mode="fused", **training):
    return Config(model=ModelConfig(**SMOKE1),
                  training=TrainingConfig(batch_size=B, compute_dtype="float32",
                                          gan_step_mode=mode, **training)).validate()


def port_config(mode="fused", **training):
    return tcfgs.Config(model=tcfgs.ModelConfig(**SMOKE1),
                        training=tcfgs.TrainingConfig(compute_dtype="float32", batch_size=B,
                                                      gan_step_mode=mode, **training)).validate()


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


def make_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s = SMOKE1["image_size"]
    return {k: rng.uniform(-1, 1, (B, s, s, 3)).astype(np.float32)
            for k in ("image", "future_image")}


_JAX = {}


def jax_trainer(mode="fused", **training) -> JaxStage1Trainer:
    """One JAX trainer per configuration, so each jitted function compiles once."""
    key = (mode, tuple(sorted(training.items())))
    if key not in _JAX:
        _JAX[key] = JaxStage1Trainer(jax_config(mode, **training),
                                     jax_synthesize_vgg19_params(max_width=VGG_WIDTH))
    return _JAX[key]


@pytest.fixture(scope="module")
def jax_init():
    state = jax_trainer().init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    state = state.replace(g_params=randomize(state.g_params, rng),
                          batch_stats=randomize(state.batch_stats, rng),
                          d_params=randomize(state.d_params, rng))
    return jax.device_get(state)


def port_params(state) -> dict:
    return bridge.stage1_trainer_from_jax(state.g_params, state.d_params, state.batch_stats)


def port_trainer(jax_state, mode="fused", **training) -> Stage1Trainer:
    trainer = Stage1Trainer(port_config(mode, **training),
                            synthesize_vgg19_params(max_width=VGG_WIDTH), device="cpu")
    trainer.load_parameters(port_params(jax_state))
    return trainer


def test_bridge_covers_the_trainer_trees(jax_init):
    """Every parameter and BN statistic of both networks comes from the JAX
    trees, keyed as FinalGenerator (stage1.*) and apart from stage 2's
    discriminator (image_discriminator.*); init_parameters gives the same
    shapes with JAX's init laws."""
    params = port_params(jax_init)
    trainer = Stage1Trainer(port_config(), synthesize_vgg19_params(max_width=VGG_WIDTH),
                            device="cpu")
    assert set(params) == set(trainer.model.state_dict())
    assert {k.split(".")[0] for k in params} == {"stage1", "image_discriminator"}
    np.testing.assert_array_equal(params["image_discriminator.logit.weight"].numpy(),
                                  jax_init.d_params["logit"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        params["stage1.pose_encoder.dec0a.bn.running_var"].numpy(),
        jax_init.batch_stats["pose_encoder"]["dec0a_bn"]["BatchNorm_0"]["var"])
    got = trainer.init_parameters(3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                          for k, v in params.items()}
    for key, val in got.items():
        if key.endswith(("bias", "running_mean")):
            assert not val.any(), key
        elif key.endswith(("bn.weight", "running_var")):
            assert bool((val == 1).all()), key
        else:  # Xavier-uniform, as JAX's
            o, i, kh, kw = val.shape
            bound = float(np.sqrt(6.0 / ((i + o) * kh * kw)))
            assert 0.5 * bound < float(val.abs().max()) <= bound, key
    with pytest.raises(ValueError, match="unknown stage-1"):
        bridge.stage1_trainer_from_jax({"vgg": {"w": np.zeros(1)}}, {}, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batchnorm_matches_flax(rng, dtype):
    """Train-mode BN: the output (batch statistics over N, H, W in f32, the
    fast variance) and the moving statistics after one update, against
    Flax's nn.BatchNorm(momentum=0.999); outside updating_batch_stats the
    statistics stay. f32 atol 1e-5; a bf16 input gives a bf16 output within
    one bf16 step."""
    x = (rng.normal(size=(3, 5, 6, 8)) * 2 + 0.7).astype(np.float32)
    jdt = getattr(jax.numpy, dtype)
    mod = JaxBatchNorm(dtype=jdt)
    v = jax.jit(lambda r: mod.init(r, x, train=True))(jax.random.PRNGKey(0))
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng)}
    want, new = mod.apply(v, jax.numpy.asarray(x, jdt), train=True, mutable=["batch_stats"])
    want_eval = mod.apply(v, jax.numpy.asarray(x, jdt), train=False)
    bn = BatchNorm(8)
    p, s = v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    before = {k: t.clone() for k, t in bn.state_dict().items()}
    with torch.no_grad():
        bn(xt, train=True)
        assert all(torch.equal(before[k], t) for k, t in bn.state_dict().items())
        got_eval = bn(xt, train=False)
        with updating_batch_stats(bn):
            got = bn(xt, train=True)
    assert not bn.update_stats and got.dtype == xt.dtype
    for g, w in ((got, want), (got_eval, want_eval)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            assert np.all(np.abs(g - w) <= 2.0**-7 * np.maximum(np.abs(w), np.abs(g)))
    ns = new["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(ns["mean"]), atol=STATS_ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(ns["var"]), atol=STATS_ATOL)


@pytest.mark.parametrize("size", [32, 40])
def test_image_discriminator_matches_jax(jax_init, size):
    """The PatchGAN (pre-pad 1, then SAME: asymmetric from the second layer
    on) within atol 1e-5, on the trainer's randomized tree; a 40^2 input
    takes other pads than 32^2."""
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(JaxImageDiscriminator(filters=8).apply)({"params": jax_init.d_params}, x)
    disc = ImageDiscriminator(8)
    prefix = "image_discriminator."
    disc.load_state_dict({k[len(prefix):]: v for k, v in port_params(jax_init).items()
                          if k.startswith(prefix)})
    with torch.no_grad():
        got = disc(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pair_mode", ["concat", "interleave"])
def test_perceptual_loss_matches_jax(tmp_path, pair_mode):
    """The VGG19 loss on [0, 255] images, within rtol 1e-5, for both pair
    layouts; vgg19.npy read by load_vgg19_params gives JAX's dict."""
    params = jax_synthesize_vgg19_params(max_width=VGG_WIDTH)
    mine = synthesize_vgg19_params(max_width=VGG_WIDTH)
    for name in params:
        for leaf in ("kernel", "bias"):
            assert np.array_equal(params[name][leaf], mine[name][leaf])
    path = tmp_path / "vgg19.npy"
    np.save(path, {n: [p["kernel"], p["bias"]] for n, p in params.items()}, allow_pickle=True)
    loaded = load_vgg19_params(str(path))
    assert all(np.array_equal(loaded[n]["kernel"], params[n]["kernel"]) for n in params)
    rng = np.random.default_rng(11)
    gt, pred = (rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = jax_perceptual_loss(params, gt, pred, pair_mode=pair_mode)
    got = perceptual_loss(prepare_vgg19(loaded, "cpu"), torch.from_numpy(gt),
                          torch.from_numpy(pred), pair_mode=pair_mode)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_generator_forward_matches_jax(jax_init, train):
    """Stage1Generator's forward (both frames through the pose encoder as one
    batch, the maps, the translator's training form, the blend) and, in
    train mode, the moved BN statistics. Outputs within rtol 1e-4 and atol
    1e-5 with the moving statistics; with batch statistics atol 1e-4: the
    fast variance E[x^2] - E[x]^2 of a batch of two cancels, and a dozen BN
    layers in a row carry that reassociation difference forward."""
    jt = jax_trainer()
    batch = make_batch(1)
    v = {"params": jax_init.g_params, "batch_stats": jax_init.batch_stats}
    if train:
        want, new = jax.jit(lambda v, a, b: jt.generator.apply(
            v, a, b, train=True, mutable=["batch_stats"]))(v, batch["image"], batch["future_image"])
        want_stats = bridge.stage1_trainer_from_jax({}, {}, new["batch_stats"])
    else:
        want = jax.jit(lambda v, a, b: jt.generator.apply(v, a, b, train=False))(
            v, batch["image"], batch["future_image"])
        want_stats = {k: v for k, v in port_params(jax_init).items() if "running" in k}
    trainer = port_trainer(jax_init)
    with torch.no_grad(), updating_batch_stats(trainer.generator):
        got = trainer.generator(*(torch.from_numpy(batch[k]) for k in ("image", "future_image")),
                                train=train)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4 if train else 1e-5, err_msg=k)
    state = trainer.model.state_dict()
    assert want_stats and all(k in state for k in want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("bn_eval_mode", ["inference", "train"])
def test_eval_step_matches_jax(jax_init, bn_eval_mode):
    """Losses and PSNR on a test batch in both BN modes; eval keeps no statistic."""
    jt = jax_trainer(bn_eval_mode=bn_eval_mode)
    trainer = port_trainer(jax_init, bn_eval_mode=bn_eval_mode)
    batch = make_batch(4)
    want = jax.jit(jt.eval_step)(jax_init, batch)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    got = trainer.eval_step(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=METRIC_RTOL, err_msg=k)
    assert all(torch.equal(before[k], v) for k, v in trainer.model.state_dict().items())


@pytest.mark.parametrize("summary_bn_mode", ["inference", "train"])
def test_stage1_summary_images_match_jax(jax_init, summary_bn_mode):
    """The seven summary images in both BN modes, with the tolerances of
    test_generator_forward_matches_jax."""
    from kpvid_tpu_torch.eval.visualize import stage1_summary_images

    jt = jax_trainer(summary_bn_mode=summary_bn_mode)
    trainer = port_trainer(jax_init, summary_bn_mode=summary_bn_mode)
    batch = make_batch(5)
    colors = get_n_colors(SMOKE1["n_pts"])
    assert np.array_equal(np.asarray(colors), np.asarray(jax_get_n_colors(SMOKE1["n_pts"])))
    want = jax_stage1_summary_images(jt, jax_init, batch, colors)
    got = stage1_summary_images(trainer, batch, colors)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), rtol=1e-4,
                                   atol=1e-4 if summary_bn_mode == "train" else 1e-5, err_msg=k)


_JAX_RUNS = {}


def _run_jax(mode, jax_state, batches, n_steps):
    """JAX's state after each step and its metrics, 3 steps run once per mode."""
    if mode not in _JAX_RUNS:
        jt = jax_trainer(mode)
        step = jax.jit(jt.train_step_two_batch if mode == "two_batch"
                       else jt.train_step_dg if mode == "fused_dg" else jt.train_step)
        state, states, history = jax_state, [], []
        for i in range(3):
            args = (batches[2 * i], batches[2 * i + 1]) if mode == "two_batch" else (batches[i],)
            state, metrics = step(state, *args)
            states.append(jax.device_get(state))
            history.append({k: float(v) for k, v in metrics.items()})
        _JAX_RUNS[mode] = (states, history)
    states, history = _JAX_RUNS[mode]
    return states[n_steps - 1], history[:n_steps]


def _run_port(mode, jax_state, batches, n_steps):
    trainer = port_trainer(jax_state, mode)
    first_grads = {}
    apply = trainer._apply

    def recording_apply(opt, params, grads):  # keep the first update's gradients
        for p, g in zip(params, grads):
            first_grads.setdefault(id(p), g.clone())
        apply(opt, params, grads)

    trainer._apply = recording_apply
    history = []
    for i in range(n_steps):
        if mode == "two_batch":
            metrics = trainer.train_step_two_batch(batches[2 * i], batches[2 * i + 1])
        elif mode == "fused_dg":
            metrics = trainer.train_step_dg(batches[i])
        else:
            metrics = trainer.train_step(batches[i])
        history.append({k: float(v) for k, v in metrics.items()})
    grads = {name: first_grads[id(p)] for name, p in trainer.model.named_parameters()}
    return trainer, history, grads


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("mode", ["fused", "fused_dg", "two_batch"])
def test_train_steps_match_jax(jax_init, mode, n_steps):
    """Metrics of every step within rtol 1e-4, both networks' parameters
    and the BN statistics after the steps (module docstring's tolerances);
    every parameter the losses reach moved."""
    batches = [make_batch(10 + i) for i in range(6)]
    want_state, want_hist = _run_jax(mode, jax_init, batches, n_steps)
    trainer, got_hist, grads = _run_port(mode, jax_init, batches, n_steps)
    assert trainer.step == n_steps == int(want_state.step)
    for got, want in zip(got_hist, want_hist):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    want = port_params(want_state)
    init = port_params(jax_init)
    state = trainer.model.state_dict()
    moved, unused = 0, 0
    for name, val in state.items():
        diff = (val - want[name]).abs()
        if "running_" in name:
            assert bool((diff <= STATS_ATOL).all()), (name, float(diff.max()))
            assert not torch.equal(val, init[name]), name  # every statistic moved
            continue
        sign_step = grads[name].abs() < 1e-6
        if name.endswith((".conv.bias", ".heat.bias")):  # zero gradients in exact arithmetic
            sign_step = torch.ones_like(sign_step)
        bound = torch.where(sign_step, torch.full_like(diff, 2.5 * LR * n_steps),
                            torch.full_like(diff, PARAM_ATOL))
        beyond = diff > bound
        assert int(beyond.sum()) <= 0.02 * diff.numel(), (name, int(beyond.sum()))
        assert bool((diff <= bound + LR / 2 * (n_steps - 1)).all()), (name, float(diff.max()))
        if name.startswith(UNUSED):
            assert torch.equal(val, init[name]) and not grads[name].any(), name
            unused += 1
        else:
            moved += int(not torch.equal(val, init[name]))
    assert unused == 8 and moved == len(grads) - unused


def test_train_step_on_a_reloaded_state_continues_the_run(jax_init):
    """state_arrays / load_state_arrays carry the step, both networks, the
    BN statistics and both Adam states: a trainer restored after step 1
    takes step 2 to the same bits as the trainer that ran both."""
    batches = [make_batch(20 + i) for i in range(2)]
    a = port_trainer(jax_init)
    a.train_step(batches[0])
    arrays = {k: v.clone() for k, v in a.state_arrays().items()}
    assert {k.split(".")[0] for k in arrays} == {"step", "stage1", "image_discriminator",
                                                "g_opt", "d_opt"}
    b = port_trainer(jax_init)
    b.load_state_arrays({k: v.numpy() for k, v in arrays.items()})
    for t in (a, b):
        t.train_step(batches[1])
    sa, sb = a.state_arrays(), b.state_arrays()
    assert sorted(sa) == sorted(sb) and int(sb["step"]) == 2
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_remat_vgg_gives_the_same_step(jax_init):
    """training.remat_vgg recomputes the VGG tower in the backward with the
    same numbers."""
    batch = make_batch(30)
    plain, remat = port_trainer(jax_init), port_trainer(jax_init, remat_vgg=True)
    assert remat.remat_vgg and not plain.remat_vgg
    ga, _, ma = plain.g_grads(*plain._pair_of(batch))
    gb, _, mb = remat.g_grads(*remat._pair_of(batch))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.allclose(x, y, rtol=1e-6, atol=1e-9) for x, y in zip(ga, gb))


# --------------------------------------------------------------- data path
@pytest.fixture(scope="module")
def pair_tree(tmp_path_factory):
    """Videos of 14 frames, so that t + d wraps around often."""
    from kpvid_tpu_torch.data import make_synthetic_penn_tree

    root = tmp_path_factory.mktemp("pairs")
    make_synthetic_penn_tree(root, n_train=3, n_test=2, frames_per_video=14)
    return root


@pytest.mark.parametrize("native_ops", ["off", "auto"])
@pytest.mark.parametrize("subset", ["train", "test"])
def test_image_pair_samples_match_jax(pair_tree, subset, native_ops):
    """ImagePairDataset's samples, byte for byte JAX's for the same rng: the
    train split's random video, pair, rotation, crop, flip and filter, and
    the test split's fixed pair and quirk-Q8 crop; both frame backends."""
    from kpvid_tpu_torch.data import ImagePairDataset

    want_ds = JaxImagePairDataset(str(pair_tree), subset, image_size=32, native_ops=native_ops)
    got_ds = ImagePairDataset(str(pair_tree), subset, image_size=32, native_ops=native_ops)
    assert len(got_ds) == len(want_ds)
    for seed in range(12):
        idx = seed % len(got_ds)
        want = want_ds.sample(idx, np.random.default_rng(seed))
        got = got_ds.sample(idx, np.random.default_rng(seed))
        assert sorted(got) == sorted(want) == ["future_image", "image"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == (32, 32, 3)
            assert got[k].tobytes() == want[k].tobytes(), (seed, k)


BAD_YAML = {
    "upsample_mode": "model: {upsample_mode: bicubic}",
    "lstm_unroll": "model: {lstm_unroll: 0}",
    "bn_eval_mode": "training: {bn_eval_mode: eval}",
    "summary_bn_mode": "training: {summary_bn_mode: eval}",
    "gan_step_mode": "training: {gan_step_mode: alternate}",
    "pair_batching": "training: {pair_batching: stack}",
}


@pytest.mark.parametrize("field", sorted(BAD_YAML))
def test_validate_refuses_what_jax_refuses(tmp_path, field):
    """Each YAML that kpvid_tpu's load_config refuses, the port's refuses with
    the same message."""
    path = tmp_path / "bad.yaml"
    path.write_text(BAD_YAML[field] + "\n")
    with pytest.raises(ValueError, match=field) as want:
        jax_load_config(path)
    with pytest.raises(ValueError, match=field) as got:
        tcfgs.load_config(path)
    assert str(got.value) == str(want.value)


def test_config_reads_the_stage1_fields(tmp_path):
    """paths.vggnet and training.{remat_vgg, bn_eval_mode, summary_bn_mode}
    with JAX's defaults, and as a YAML sets them."""
    default, want = tcfgs.Config(), Config()
    assert default.paths.vggnet == want.paths.vggnet
    for f in ("remat_vgg", "bn_eval_mode", "summary_bn_mode"):
        assert getattr(default.training, f) == getattr(want.training, f), f
    path = tmp_path / "c.yaml"
    path.write_text("paths: {vggnet: /x/vgg.npy}\ntraining: {remat_vgg: true, bn_eval_mode: train,"
                    " summary_bn_mode: train}\n")
    got, want = tcfgs.load_config(path), jax_load_config(path)
    assert got.paths.vggnet == want.paths.vggnet == "/x/vgg.npy"
    assert dataclasses.asdict(got.training)["remat_vgg"] is True
    for f in ("bn_eval_mode", "summary_bn_mode"):
        assert getattr(got.training, f) == getattr(want.training, f) == "train"


# ---------------------------------------------------------------- the CLI
CLI_YAML = """
paths: {{data_dir: '{root}/penn', log_dir: '{log}', vggnet: '{root}/vgg19.npy'}}
training: {{compute_dtype: float32, batch_size: 2, n_steps: 4, checkpoint_interval: 2,
            summary_interval: 2, test_interval: 4, log_interval: 1}}
model: {{n_pts: 4, n_action: 9, cell_info: [32, 32], vae_dim: 8, n_future_frames: 8,
         image_size: 32, heatmap_size: 8, encoder_filters: 8, translator_filters: 16,
         pose_decoder_filters: 16, discriminator_filters: 8}}
data: {{num_workers: 2, sequence_len: 9, eval_batch_size: 2, labeler_chunk: 16}}
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """python -m kpvid_tpu_torch.train --mode detector_translator --synthetic
    on the CPU, 4 steps, checkpoints at 2 and 4, with a vgg19.npy of
    16-channel synthesized weights."""
    from kpvid_tpu_torch.train import main

    root = tmp_path_factory.mktemp("cli1")
    np.save(root / "vgg19.npy", {n: [p["kernel"], p["bias"]] for n, p in
                                 synthesize_vgg19_params(max_width=VGG_WIDTH).items()},
            allow_pickle=True)
    for log in ("a", "b"):
        (root / f"{log}.yaml").write_text(CLI_YAML.format(root=root, log=root / log))
    run = main(["--mode", "detector_translator", "--synthetic", "--device", "cpu",
                "--config", str(root / "a.yaml")])
    return root, run


def test_train_cli_resume_equals_uninterrupted(trained):
    """A second run that finds only ckpt-2 resumes and ends with ckpt-4's
    arrays, bit for bit; the logs and summaries of the stage-1 CLI."""
    from kpvid_tpu_torch.checkpoint import list_checkpoint_steps, load_checkpoint
    from kpvid_tpu_torch.train import main

    root, run = trained
    ck = root / "a" / "detector_translator"
    assert run["start_step"] == 0 and list_checkpoint_steps(ck) == [2, 4]
    assert all(np.isfinite(v) for v in run["metrics"].values())
    assert sorted(run["metrics"]) == sorted(["loss_D", "D_real", "D_fake", "loss_G",
                                             "reconstruction_metric", "G_adv_loss", "lr"])
    assert int(load_checkpoint(ck / "ckpt-2")["step"]) == 3
    assert (ck / "train_metrics.jsonl").read_text().count("\n") == 2
    assert "psnr" in (ck / "test_metrics.jsonl").read_text()
    assert len(list((ck / "train_images").iterdir())) == 2 * 7 * 2
    assert not (root / "penn" / "pseudo_labels").exists()  # stage 1 writes no labels
    shutil.copytree(ck / "ckpt-2", root / "b" / "detector_translator" / "ckpt-2")
    resumed = main(["--mode", "detector_translator", "--device", "cpu", "--config",
                    str(root / "b.yaml")])
    assert resumed["start_step"] == 3
    want = load_checkpoint(ck / "ckpt-4")
    got = load_checkpoint(root / "b" / "detector_translator" / "ckpt-4")
    assert sorted(got) == sorted(want) and int(got["step"]) == 4
    assert any(k.startswith("g_opt.stage1.pose_encoder.") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "detector_translator", "--config", str(root / "a.yaml")])


def test_labeler_and_evaluate_take_a_stage1_checkpoint(trained):
    """make_pseudo_labels and evaluate take the stage-1 trainer's ckpt-N (or
    the directory above it) as their stage-1 checkpoint: the pose encoder,
    and evaluate's whole stage-1 generator, hold the trained tensors."""
    from kpvid_tpu_torch import evaluate, make_pseudo_labels
    from kpvid_tpu_torch.checkpoint import load_checkpoint, save_parameters
    from kpvid_tpu_torch.eval import FinalGenerator
    from kpvid_tpu_torch.serve import load_generator_parameters

    root, _ = trained
    ck = root / "a" / "detector_translator"
    trained_arrays = load_checkpoint(ck / "ckpt-4")
    cfg = tcfgs.load_config(root / "a.yaml")
    enc, n = make_pseudo_labels.load_pose_encoder(cfg, str(ck / "ckpt-4"), torch.device("cpu"))
    assert n == len(enc.state_dict())
    for name, val in enc.state_dict().items():
        assert np.array_equal(val.numpy(), trained_arrays["stage1.pose_encoder." + name]), name
    stats = make_pseudo_labels.main(["--config", str(root / "a.yaml"), "--checkpoint", str(ck),
                                     "--device", "cpu"])
    assert stats["videos"] == 6
    labels = sorted((root / "penn" / "pseudo_labels").glob("*.npy"))
    assert len(labels) == 6 and all(np.isfinite(np.load(p)).all() for p in labels)

    final = FinalGenerator(cfg, device="cpu")
    s2 = save_parameters(root / "s2.npz", {k: v for k, v in final.init_parameters(0).items()
                                           if k.startswith("stage2.")})
    params = load_generator_parameters(final.model.state_dict(), str(ck), str(s2))
    stage1 = [k for k in params if k.startswith("stage1.")]
    assert stage1 and all(np.array_equal(params[k].numpy(), trained_arrays[k]) for k in stage1)
    out = evaluate.main(["--config", str(root / "a.yaml"), "--checkpoint_stage1",
                         str(ck / "ckpt-4"), "--checkpoint_stage2", str(s2), "--save_dir",
                         str(root / "eval"), "--device", "cpu"])
    assert out["samples"] == 2 and len(list((root / "eval" / "0000" / "pred_seq").iterdir())) == 8
