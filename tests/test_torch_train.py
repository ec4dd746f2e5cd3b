"""The port's stage-2 trainer against kpvid_tpu's, on the CPU, in f32.

Smoke widths: cell_info (32, 32), K = 4, 3 actions, vae_dim 8, T = 8,
batch 4. The JAX trainer initializes both networks; the bridge carries the
same trees into the port; batches come from numpy seeds and the VAE noise
is JAX's own draw for each step (``jax.random.normal`` of the step key, split
into (d, g) keys where the mode does), handed to the port as an argument.

Tolerances: metrics rtol 1e-4 (f32, float reassociation only); parameters
after the steps atol 2e-6 (the updates are lr = 1e-4 in size, so this is
2% of one update), except where Adam's first update is a sign step: an
element whose first-step gradient is below 1e-6 in magnitude may differ by
up to 2 * lr per step taken, since lr * g / (|g| + 1e-8) turns a tiny
difference in g into a different step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kpvid_tpu.configs import Config, LRConfig, ModelConfig, TrainingConfig
from kpvid_tpu.losses import discriminator_loss as jax_discriminator_loss
from kpvid_tpu.losses import kl_raw_sigma as jax_kl
from kpvid_tpu.losses import seq_recon_loss as jax_recon
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer
from kpvid_tpu.train.state import make_lr_schedule as jax_lr_schedule
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.losses import discriminator_loss, kl_raw_sigma, seq_recon_loss
from kpvid_tpu_torch.train import Stage2Trainer
from kpvid_tpu_torch.train.state import make_lr_schedule

TRAIN_SMOKE = dict(n_pts=4, n_action=3, cell_info=(32, 32), vae_dim=8, n_future_frames=8,
                   image_size=32, heatmap_size=8)
B = 4
LR = 1e-4
PARAM_ATOL = 2e-6
METRIC_RTOL = 1e-4


def jax_config(mode="fused", **training):
    return Config(model=ModelConfig(**TRAIN_SMOKE),
                  training=TrainingConfig(batch_size=B, compute_dtype="float32",
                                          gan_step_mode=mode, **training)).validate()


def port_config(mode="fused", **training):
    return tcfgs.Config(model=tcfgs.ModelConfig(**TRAIN_SMOKE),
                        training=tcfgs.TrainingConfig(compute_dtype="float32", batch_size=B,
                                                      gan_step_mode=mode, **training)).validate()


def make_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k, t, a = TRAIN_SMOKE["n_pts"], TRAIN_SMOKE["n_future_frames"], TRAIN_SMOKE["n_action"]
    start = rng.uniform(-0.6, 0.6, (B, 1, k, 2))
    seq = np.clip(start + rng.normal(0, 0.05, (B, t + 1, k, 2)).cumsum(axis=1), -1, 1)
    return {"keypoints": seq[:, 0].astype(np.float32),
            "real_seq": seq[:, 1:].astype(np.float32),
            "action_code": np.eye(a, dtype=np.float32)[rng.integers(0, a, B)]}


@pytest.fixture(scope="module")
def jax_init():
    trainer = JaxStage2Trainer(jax_config())
    state = trainer.init_state(jax.random.PRNGKey(0))
    return jax.device_get(state)


def port_trainer(jax_state, mode="fused") -> Stage2Trainer:
    trainer = Stage2Trainer(port_config(mode), device="cpu")
    trainer.load_parameters(bridge.stage2_trainer_from_jax(jax_state.g_params,
                                                           jax_state.d_params))
    return trainer


def noise_of(key, mode):
    vae = TRAIN_SMOKE["vae_dim"]
    if mode == "fused":
        return (np.asarray(jax.random.normal(key, (B, vae), jnp.float32)),)
    kd, kg = jax.random.split(key)
    return tuple(np.asarray(jax.random.normal(k, (B, vae), jnp.float32)) for k in (kd, kg))


def flat(batch):
    b = batch["keypoints"].shape[0]
    return (torch.from_numpy(batch["keypoints"].reshape(b, -1)),
            torch.from_numpy(batch["real_seq"].reshape(b, batch["real_seq"].shape[1], -1)),
            torch.from_numpy(batch["action_code"]))


def test_bridge_covers_the_trainer_trees(jax_init):
    """Every parameter of both trainer networks comes from the JAX trees."""
    params = bridge.stage2_trainer_from_jax(jax_init.g_params, jax_init.d_params)
    trainer = Stage2Trainer(port_config(), device="cpu")
    assert set(params) == set(trainer.model.state_dict())
    np.testing.assert_array_equal(params["discriminator.head.weight"].numpy(),
                                  jax_init.d_params["Dense_0"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(params["stage2.enc_lstm.lstm_0_kernel"].numpy(),
                                  jax_init.g_params["enc_lstm"]["lstm_0_kernel"])
    got = trainer.init_parameters(3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                          for k, v in params.items()}
    for key, val in got.items():
        if key.endswith("bias"):
            assert not val.any(), key
        elif key.endswith("to_coord.weight"):
            assert abs(float(val.std()) - 0.02) < 0.005
        else:  # Xavier-uniform, as JAX's
            bound = float(np.sqrt(6.0 / sum(val.shape)))
            assert 0.5 * bound < float(val.abs().max()) <= bound, key


def test_forward_encode_and_discriminator_match_jax(jax_init):
    """encode, the training forward and SeqDiscriminator (f32), with the relu'd
    mu / stddev / logit quirks."""
    jt = JaxStage2Trainer(jax_config())
    trainer = port_trainer(jax_init)
    batch = make_batch(1)
    first_pt, real_seq, act = flat(batch)
    noise = np.random.default_rng(2).standard_normal((B, 8)).astype(np.float32)
    g = {"params": jax_init.g_params}
    want_mu, want_sd = jax.jit(lambda p, *a: jt.generator.apply(p, *a, method=jt.generator.encode))(
        g, real_seq.numpy(), first_pt.numpy(), act.numpy())
    want_pred, _, _ = jax.jit(jt.generator.apply)(g, real_seq.numpy(), first_pt.numpy(),
                                                   act.numpy(), noise)
    want_logit = jax.jit(jt.discriminator.apply)({"params": jax_init.d_params}, real_seq.numpy())
    with torch.no_grad():
        mu, sd = trainer.generator.encode(real_seq, first_pt, act)
        pred, mu2, _ = trainer.generator(real_seq, first_pt, act, torch.from_numpy(noise))
        logit = trainer.discriminator(real_seq)
    assert (mu >= 0).all() and (sd >= 0).all() and (logit >= 0).all()
    for got, want in ((mu, want_mu), (sd, want_sd), (pred, want_pred), (logit, want_logit)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    assert torch.equal(mu, mu2)
    want_sample = jax.jit(jt.sample)(jax_init, first_pt.numpy(), act.numpy(),
                                     jax.random.PRNGKey(4))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (B, 8), jnp.float32))
    np.testing.assert_allclose(trainer.sample(first_pt, act, z).numpy(), np.asarray(want_sample),
                               rtol=1e-4, atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    pred, real = rng.uniform(-1, 1, (2, B, 8, 8)).astype(np.float32)
    mu = np.maximum(rng.normal(size=(B, 8)), 0).astype(np.float32)
    sd = np.maximum(rng.normal(size=(B, 8)), 0).astype(np.float32)  # zeros included
    logits = np.maximum(rng.normal(0, 3, (2, B, 1)), 0).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(float(seq_recon_loss(t(pred), t(real))),
                               float(jax_recon(pred, real)), rtol=1e-6)
    np.testing.assert_allclose(float(kl_raw_sigma(t(mu), t(sd))), float(jax_kl(mu, sd)), rtol=1e-6)
    assert np.isfinite(float(kl_raw_sigma(t(mu), torch.zeros_like(t(sd)))))
    for got, want in zip(discriminator_loss(t(logits[0]), t(logits[1])),
                         jax_discriminator_loss(logits[0], logits[1])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_stage2_summary_images_match_jax(jax_init):
    """The stage-2 summary images on JAX's noise: the input image, the first
    frame's points at full resolution and the predicted and real pose strips,
    within atol 1e-5 (f32 renders of points that agree to 1e-6)."""
    from kpvid_tpu.eval.visualize import stage2_summary_images as jax_summary
    from kpvid_tpu.utils import get_n_colors as jax_colors
    from kpvid_tpu_torch.eval.visualize import stage2_summary_images
    from kpvid_tpu_torch.utils import get_n_colors

    jt = JaxStage2Trainer(jax_config())
    trainer = port_trainer(jax_init)
    batch = make_batch(6)
    batch["image"] = np.random.default_rng(6).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    colors = get_n_colors(TRAIN_SMOKE["n_pts"])
    assert np.array_equal(np.asarray(colors), np.asarray(jax_colors(TRAIN_SMOKE["n_pts"])))
    key = jax.random.PRNGKey(8)
    want = jax_summary(jt, jax_init, batch, colors, key)
    noise = np.asarray(jax.random.normal(key, (2, TRAIN_SMOKE["vae_dim"])))
    got = stage2_summary_images(trainer, batch, colors, noise)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_eval_step_matches_jax(jax_init):
    jt = JaxStage2Trainer(jax_config())
    trainer = port_trainer(jax_init)
    batch = make_batch(4)
    key = jax.random.PRNGKey(9)
    want = jax.jit(jt.eval_step)(jax_init, batch, key)
    got = trainer.eval_step(batch, noise_of(key, "fused")[0])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=METRIC_RTOL, err_msg=k)


def _run_jax(mode, jax_state, batches, keys):
    jt = JaxStage2Trainer(jax_config(mode))
    step = jax.jit(jt.train_step_two_batch if mode == "two_batch"
                   else jt.train_step_dg if mode == "fused_dg" else jt.train_step)
    state, history = jax_state, []
    for i, key in enumerate(keys):
        args = (batches[2 * i], batches[2 * i + 1]) if mode == "two_batch" else (batches[i],)
        state, metrics = step(state, *args, key)
        history.append({k: float(v) for k, v in metrics.items()})
    return jax.device_get(state), history


def _run_port(mode, jax_state, batches, keys):
    trainer = port_trainer(jax_state, mode)
    first_grads = {}
    apply = trainer._apply

    def recording_apply(opt, params, grads):  # keep the first update's gradients
        for p, g in zip(params, grads):
            first_grads.setdefault(id(p), g.clone())
        apply(opt, params, grads)

    trainer._apply = recording_apply
    history = []
    for i, key in enumerate(keys):
        noise = noise_of(key, mode)
        if mode == "two_batch":
            metrics = trainer.train_step_two_batch(batches[2 * i], batches[2 * i + 1], *noise)
        elif mode == "fused_dg":
            metrics = trainer.train_step_dg(batches[i], *noise)
        else:
            metrics = trainer.train_step(batches[i], *noise)
        history.append({k: float(v) for k, v in metrics.items()})
    grads = {name: first_grads[id(p)] for name, p in trainer.model.named_parameters()}
    return trainer, history, grads


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("mode", ["fused", "fused_dg", "two_batch"])
def test_train_steps_match_jax(jax_init, mode, n_steps):
    """Metrics of every step within rtol 1e-4 and both networks' parameters
    after the steps (module docstring's tolerance), on JAX's noise."""
    batches = [make_batch(10 + i) for i in range(2 * n_steps)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(n_steps)]
    want_state, want_hist = _run_jax(mode, jax_init, batches, keys)
    trainer, got_hist, grads = _run_port(mode, jax_init, batches, keys)
    assert trainer.step == n_steps == int(want_state.step)
    for got, want in zip(got_hist, want_hist):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    want = bridge.stage2_trainer_from_jax(want_state.g_params, want_state.d_params)
    moved = 0
    for name, p in trainer.model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        sign_step = grads[name].abs() < 1e-6
        bound = torch.where(sign_step, torch.full_like(diff, 2 * LR * n_steps),
                            torch.full_like(diff, PARAM_ATOL))
        assert bool((diff <= bound).all()), (name, float(diff.max()))
        moved += int((p.detach() != jax_init_param(jax_init, name)).any())
    assert moved == len(want)  # every parameter moved


def jax_init_param(jax_state, name):
    return bridge.stage2_trainer_from_jax(jax_state.g_params, jax_state.d_params)[name]


@pytest.mark.parametrize("warmup", [0, 100])
def test_lr_schedule_matches_optax(warmup):
    lr = LRConfig(start_val=3e-4, step=20_000, decay=0.95, scale=2.0, warmup_steps=warmup)
    want = jax_lr_schedule(lr)
    got = make_lr_schedule(tcfgs.LRConfig(**dataclasses.asdict(lr)))
    for count in (0, 1, 20_000):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7, err_msg=count)
    assert got(0) == pytest.approx(6e-4 * (1.0 / warmup if warmup else 1.0), rel=1e-6)


def test_config_refuses_knobs_of_later_slices():
    with pytest.raises(ValueError, match="'Training knobs'"):
        port_config(grad_accum=2)
    with pytest.raises(ValueError, match="'Multi-GPU'"):
        port_config(dp_grad_dtype="bfloat16")
    with pytest.raises(ValueError, match="'Multi-GPU'"):
        dataclasses.replace(port_config(), parallel=tcfgs.ParallelConfig(mesh_data=4)).validate()


# --------------------------------------------------------------- data path
@pytest.fixture(scope="module")
def short_tree(tmp_path_factory):
    """Videos of 20-27 frames: sequence_len 33 takes the gap < 1 midpoint
    interpolation, sequence_len 9 strided frames."""
    from kpvid_tpu_torch.data import make_synthetic_penn_tree, make_synthetic_pseudo_labels

    root = tmp_path_factory.mktemp("penn")
    make_synthetic_penn_tree(root, n_train=4, n_test=2, frames_per_video=20)
    make_synthetic_pseudo_labels(root, n_pts=4)
    return root


def _take(pipe, n):
    out = []
    for batch in pipe.batches():
        out.append(batch)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("subset,seq_len,start", [("train", 33, 0), ("train", 9, 0),
                                                  ("train", 9, 7), ("test", 33, 0)])
def test_sequence_batches_match_jax(short_tree, subset, seq_len, start):
    """SequenceDataset through HostDataPipeline, byte for byte JAX's: the train
    split augmented (rotation, flip, scale, random order; both gap branches),
    a resumed start_sample, and the test split with its image sequence."""
    from kpvid_tpu.data import HostDataPipeline as JaxPipe
    from kpvid_tpu.data import SequenceDataset as JaxSeq
    from kpvid_tpu.data.synthetic import make_synthetic_pseudo_labels as jax_labels
    from kpvid_tpu_torch.data import HostDataPipeline, SequenceDataset

    jax_dir = short_tree.parent / "jax_labels"
    if not jax_dir.exists():  # the JAX writer's label files are the port's
        import shutil

        shutil.copytree(short_tree, jax_dir)
        jax_labels(jax_dir, n_pts=4)
        for f in sorted((short_tree / "pseudo_labels").iterdir()):
            assert f.read_bytes() == (jax_dir / "pseudo_labels" / f.name).read_bytes()
    train = subset == "train"
    kw = dict(n_pts=4, n_action=9, sequence_len=seq_len, image_size=32,
              with_image_seq=not train)
    pkw = dict(batch_size=3, shuffle=train, repeat=train, num_workers=3, seed=5,
               start_sample=start)
    want = _take(JaxPipe(JaxSeq(str(short_tree), subset, **kw), **pkw), 3)
    got = _take(HostDataPipeline(SequenceDataset(str(short_tree), subset, **kw), **pkw), 3)
    assert len(got) == len(want) == (3 if train else 1)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    if start:  # the resumed stream is the uninterrupted one's tail
        full = _take(HostDataPipeline(SequenceDataset(str(short_tree), subset, **kw),
                                      **dict(pkw, start_sample=0)), 6)
        for k in got[0]:
            assert np.array_equal(np.concatenate([b[k] for b in full])[start:start + 9],
                                  np.concatenate([b[k] for b in got]))


# ---------------------------------------------------------------- the CLI
CLI_YAML = """
paths: {{data_dir: '{root}/penn', log_dir: '{log}'}}
training: {{compute_dtype: float32, batch_size: 4, n_steps: 4, checkpoint_interval: 2,
            summary_interval: 2, test_interval: 4, log_interval: 1}}
model: {{n_pts: 4, n_action: 9, cell_info: [32, 32], vae_dim: 8, n_future_frames: 8,
         image_size: 32, heatmap_size: 8, encoder_filters: 8, translator_filters: 16,
         pose_decoder_filters: 16}}
data: {{num_workers: 2, sequence_len: 9}}
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """python -m kpvid_tpu_torch.train --mode motion_generator --synthetic on
    the CPU, 4 steps, checkpoints at 2 and 4."""
    from kpvid_tpu_torch.train import main

    root = tmp_path_factory.mktemp("cli")
    for log in ("a", "b"):
        (root / f"{log}.yaml").write_text(CLI_YAML.format(root=root, log=root / log))
    run = main(["--mode", "motion_generator", "--synthetic", "--device", "cpu",
                "--config", str(root / "a.yaml")])
    return root, run


def test_train_cli_resume_equals_uninterrupted(trained):
    """A second run that finds only ckpt-2 resumes and ends with ckpt-4's
    arrays, bit for bit; the logs, summaries and refusals of the CLI."""
    import shutil

    from kpvid_tpu_torch.checkpoint import list_checkpoint_steps, load_checkpoint
    from kpvid_tpu_torch.train import main

    root, run = trained
    ck = root / "a" / "motion_generator"
    assert run["start_step"] == 0 and list_checkpoint_steps(ck) == [2, 4]
    assert all(np.isfinite(v) for v in run["metrics"].values())
    assert int(load_checkpoint(ck / "ckpt-2")["step"]) == 3  # the state after step 2
    assert (ck / "train_metrics.jsonl").read_text().count("\n") == 2
    assert (ck / "test_metrics.jsonl").read_text().count("\n") == 1
    assert len(list((ck / "train_images").iterdir())) == 2 * 4 * 2
    shutil.copytree(ck / "ckpt-2", root / "b" / "motion_generator" / "ckpt-2")
    args = ["--mode", "motion_generator", "--device", "cpu", "--config", str(root / "b.yaml")]
    resumed = main(args)
    assert resumed["start_step"] == 3
    want = load_checkpoint(ck / "ckpt-4")
    got = load_checkpoint(root / "b" / "motion_generator" / "ckpt-4")
    assert sorted(got) == sorted(want) and int(got["step"]) == 4
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for mode in ("detector_translator", "motion_generator"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--mode", mode, "--config", str(root / "a.yaml")])


def test_daemon_serves_from_a_trainer_checkpoint(trained):
    """serve's --checkpoint_stage2 takes the trainer's ckpt-N directory, the
    directory above it (the newest ckpt-N), or its state.npz; the engine's
    decoder holds the trained parameters and answers a request."""
    from argparse import Namespace

    from kpvid_tpu_torch import serve
    from kpvid_tpu_torch.checkpoint import (
        load_checkpoint,
        resolve_parameter_file,
        save_parameters,
    )
    from kpvid_tpu_torch.eval import FinalGenerator

    root, _ = trained
    ck = root / "a" / "motion_generator"
    assert resolve_parameter_file(ck) == ck / "ckpt-4" / "state.npz"
    assert resolve_parameter_file(ck / "ckpt-2") == ck / "ckpt-2" / "state.npz"
    with pytest.raises(FileNotFoundError, match="no ckpt-N"):
        resolve_parameter_file(root)
    cfg = tcfgs.load_config(root / "a.yaml")
    s1 = save_parameters(root / "s1.npz", {
        k: v for k, v in FinalGenerator(cfg, device="cpu").init_parameters(0).items()
        if k.startswith("stage1.")})
    trained_params = load_checkpoint(ck / "ckpt-4")
    for stage2 in (ck, ck / "ckpt-4", ck / "ckpt-4" / "state.npz"):
        engine = serve.load_engine(Namespace(config=str(root / "a.yaml"), checkpoint_stage1=str(s1),
                                             checkpoint_stage2=str(stage2), device="cpu"))
        state = engine.final.model.state_dict()
        for name in ("stage2.dec_lstm.lstm_1_kernel", "stage2.to_coord.weight"):
            assert np.array_equal(state[name].numpy(), trained_params[name])
    out = engine.run(np.zeros((1, 32, 32, 3), np.float32), np.array([2]),
                     np.ones((1, 8), np.float32))
    assert out["pred_im_seq"].shape == (1, 8, 32, 32, 3)


def test_trainer_checkpoints_keep_and_latest(tmp_path):
    """keep_checkpoints removes all but the newest; a ckpt-N without its
    state.npz (a write cut short) is not a checkpoint; the manager writes in
    the background and its wait() raises a failed write."""
    from kpvid_tpu_torch.checkpoint import (
        AsyncCheckpointManager,
        latest_checkpoint,
        list_checkpoint_steps,
        load_checkpoint,
        save_checkpoint,
    )

    arrays = {"step": torch.tensor(3), "w": torch.arange(6.0).reshape(2, 3)}
    for step in (1, 2, 3):
        save_checkpoint(tmp_path, "mg", step, arrays, keep=2)
    (tmp_path / "mg" / "ckpt-9").mkdir()
    assert list_checkpoint_steps(tmp_path / "mg") == [2, 3]
    assert latest_checkpoint(tmp_path / "mg") == tmp_path / "mg" / "ckpt-3"
    got = load_checkpoint(tmp_path / "mg" / "ckpt-3")
    assert got["step"].dtype == np.int64 and np.array_equal(got["w"], arrays["w"].numpy())
    manager = AsyncCheckpointManager(tmp_path, "mg", keep=1)
    manager.save(4, arrays)
    manager.wait()
    assert list_checkpoint_steps(tmp_path / "mg") == [4]
    (tmp_path / "blocked").write_text("a file where the directory should go")
    manager = AsyncCheckpointManager(tmp_path / "blocked", "mg")
    manager.save(5, arrays)
    with pytest.raises(OSError):
        manager.wait()


def test_trainer_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage2Trainer(port_config())


@pytest.mark.parametrize("angle", [-15, -7, 3, 15])
def test_native_rotate_matches_pil(angle):
    """The C++ nearest rotate of the train augmentation, byte for byte PIL's."""
    from PIL import Image

    from kpvid_tpu_torch import native

    if not native.available():
        pytest.skip("no host C++ compiler")
    src = np.random.default_rng(angle + 20).integers(0, 256, (150, 200, 3), np.uint8)
    assert np.array_equal(native.rotate_nearest(src, angle),
                          np.asarray(Image.fromarray(src).rotate(angle)))
