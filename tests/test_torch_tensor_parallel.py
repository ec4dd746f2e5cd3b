"""The port's tensor parallelism (the 'model' mesh axis) against kpvid_tpu's, on the CPU.

- The sharding rule: the port's sharded arrays are exactly the leaves that
  JAX's ``param_sharding_rules`` shards, leaf by leaf through
  ``bridge.jax_path``: at ``Config()`` (the PatchGAN's conv4 / conv5 in
  stage 1, the six LSTM layers in stage 2, from ``jax.eval_shape``) and at
  smoke widths with ``min_shard_dim`` 16 over the whole train state
  (parameters, BN statistics, Adam moments) on JAX's virtual CPU devices.
- One f32 'fused' step of each stage at meshes 1x2 and 2x2 (2 and 4
  processes of tests/torch_tp_worker.py on gloo, ``min_shard_dim`` 16, so
  that nearly every conv, BN, Dense and LSTM array shards) against JAX's
  single-device step on the global batch, with the bounds of JAX's own
  mesh-vs-single-device test (tests/test_parallel.py::
  TestTrainerMeshEquivalence, which holds JAX's mesh step to its
  single-device step): metrics rtol 1e-4 / atol 1e-6; parameters each
  within 2.05 lr and on average within 0.05 lr (one Adam step is about
  lr * sign(g), and a near-zero gradient may change sign under another
  summation order); BN statistics rtol 1e-4 / atol 1e-6. JAX's mesh step
  itself is not run here: its own test of it (marked slow) takes about a
  minute for stage 1 alone on a CPU host, and this file would need four.
- The gathered first Adam moments, (1 - b1) times the step's gradients,
  against JAX's within 1e-3 in relative L2: a gradient scaled by the axis
  size (a join whose backward sums) leaves one Adam update unchanged.
- Each rank stores only its shards (parameters and Adam moments), whose
  join is the gathered array; the replicas of both data coordinates hold
  the same bits.
- The stage-2 CLI at 1x2 (``--mesh-model 2``) for 3 steps against one
  process, within the same bounds; its full ``ckpt-3`` resumed in one
  process, and a one-process ``ckpt-2`` resumed at 1x2.
- The 'model' ranks of a data coordinate read the same shard of the data
  pipeline, so a step cannot feed them different rows; the config and mesh
  checks take JAX's.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from kpvid_tpu.configs import Config as JaxConfig
from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu.losses import synthesize_vgg19_params as jax_synthesize_vgg19_params
from kpvid_tpu.parallel import make_mesh as jax_make_mesh
from kpvid_tpu.parallel import param_sharding_rules as jax_param_sharding_rules
from kpvid_tpu.train.stage1 import Stage1Trainer as JaxStage1Trainer
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer
from kpvid_tpu_torch import bridge, parallel
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.checkpoint import load_checkpoint
from kpvid_tpu_torch.data import (
    HostDataPipeline,
    SequenceDataset,
    make_synthetic_penn_tree,
    make_synthetic_pseudo_labels,
)
from kpvid_tpu_torch.models import (
    ImageDiscriminator,
    MotionGenerator,
    SeqDiscriminator,
    Stage1Generator,
)
from kpvid_tpu_torch.train import main as train_main
from test_torch_parallel import REPO, Spawn, stage1_init, stage2_init
from test_torch_stage1 import LR, SMOKE1, VGG_WIDTH, jax_trainer, port_params
from test_torch_stage1 import make_batch as s1_batch
from test_torch_train import B as B2
from test_torch_train import TRAIN_SMOKE, noise_of
from test_torch_train import jax_config as s2_jax_config
from test_torch_train import make_batch as s2_batch

WORKER = REPO / "tests" / "torch_tp_worker.py"
MIN_SHARD = 16
MESHES = ((1, 2), (2, 2))  # (data, model)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ the rule
def jax_specs(state, min_shard_dim: int) -> dict:
    """JAX's PartitionSpec tree of a train state on a 4x2 mesh of its
    virtual CPU devices."""
    mesh = jax_make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8])
    return jax_param_sharding_rules(mesh, state, min_shard_dim)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def jax_sharded_names(specs, names, g_prefix: str, d_prefix: str) -> set:
    """The port's array names (parameters, BN statistics, Adam moments) whose
    JAX leaf, found through bridge.jax_path, is sharded over 'model'."""
    out = set()
    for name in names:
        opt, _, rest = name.partition(".") if name.startswith(("g_opt.", "d_opt.")) else ("", "", name)
        if opt:  # {g,d}_opt.{prefix}.{param}.{exp_avg,exp_avg_sq,step}
            rest, _, moment = rest.rpartition(".")
        if name == "step" or (opt and moment == "step"):
            continue  # the step counts: scalars, replicated on both sides
        prefix, _, leaf = rest.partition(".")
        path = bridge.jax_path(leaf)
        if opt:
            tree = getattr(specs.g_opt_state[0] if opt == "g_opt" else specs.d_opt_state[0],
                           {"exp_avg": "mu", "exp_avg_sq": "nu"}[moment])
        elif prefix == d_prefix:
            tree = specs.d_params
        elif path[-1] in bridge.BATCH_STATS:
            tree = specs.batch_stats
        else:
            tree = specs.g_params
        if _at(tree, path) != P():
            out.add(name)
    return out


def config_shapes(stage: int) -> tuple[dict, object]:
    """The port's full parameter shapes of a stage's trainer at Config()
    (modules on the meta device: no memory), and JAX's train state shapes."""
    m = JaxConfig().model
    with torch.device("meta"):
        if stage == 1:
            nets = {"stage1": Stage1Generator(m.n_pts, m.image_size, m.encoder_filters,
                                              m.translator_filters, m.pose_decoder_filters),
                    "image_discriminator": ImageDiscriminator(m.discriminator_filters)}
        else:
            nets = {"stage2": MotionGenerator(m.n_pts, m.n_action, m.n_future_frames,
                                              m.cell_info, m.vae_dim, encoder=True),
                    "discriminator": SeqDiscriminator(2 * m.n_pts, m.cell_info)}
    shapes = {f"{p}.{k}": tuple(v.shape) for p, net in nets.items()
              for k, v in net.state_dict().items()}
    jcfg = JaxConfig().validate()
    trainer = (JaxStage1Trainer(jcfg, jax_synthesize_vgg19_params(max_width=8)) if stage == 1
               else JaxStage2Trainer(jcfg))
    return shapes, jax.eval_shape(trainer.init_state, jax.random.PRNGKey(0))


@pytest.mark.parametrize("stage,want", [
    (1, {f"image_discriminator.conv{i}.{leaf}" for i in (4, 5) for leaf in ("weight", "bias")}),
    (2, {f"{net}.lstm_{i}_{leaf}" for net in ("stage2.enc_lstm", "stage2.dec_lstm",
                                              "discriminator.lstm")
         for i in (0, 1) for leaf in ("kernel", "bias")}),
])
def test_rule_selects_jax_leaves_at_config(stage, want):
    """At Config() on a 'model' axis of 2: the 4 stage-1 and 12 stage-2
    parameter leaves, as JAX's rule picks them from its eval_shape'd state."""
    shapes, state = config_shapes(stage)
    rules = parallel.param_sharding_rules(shapes, 2, tcfgs.Config().parallel.min_shard_dim)
    prefixes = ("stage1", "image_discriminator") if stage == 1 else ("stage2", "discriminator")
    got_jax = jax_sharded_names(jax_specs(state, 1024), shapes, *prefixes)
    assert set(rules) == got_jax == want
    assert all(rules[k] == (0 if len(shapes[k]) in (1, 4) else 1) for k in rules)
    n = sum(int(np.prod(shapes[k])) for k in rules)
    assert n == (41_946_112 if stage == 1 else 38_559_744)


# ------------------------------------------------------- the spawned ranks
def cli_yaml(root: Path, data_dir: Path, log: str) -> Path:
    path = root / f"{log}.yaml"
    path.write_text(json.dumps({
        "paths": {"data_dir": str(data_dir), "log_dir": str(root / log)},
        "training": {"compute_dtype": "float32", "batch_size": 2, "n_steps": 3,
                     "checkpoint_interval": 2, "summary_interval": 10, "test_interval": 10,
                     "log_interval": 1},
        "model": {"n_pts": 4, "n_action": 9, "cell_info": [32, 32], "vae_dim": 8,
                  "n_future_frames": 8, "image_size": 32, "heatmap_size": 8},
        "data": {"num_workers": 1, "sequence_len": 9},
        "parallel": {"min_shard_dim": MIN_SHARD},
    }))
    return path


def cli_args(conf: Path, *extra: str) -> list[str]:
    return ["--mode", "motion_generator", "--device", "cpu", "--no-images",
            "--config", str(conf), *extra]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Writes the inputs and starts the 1x2 and 2x2 runs; returns what the
    JAX side and the one-process runs need while they work."""
    root = tmp_path_factory.mktemp("tp")
    s1, s2 = stage1_init(), stage2_init()
    np.savez(root / "s1_init.npz", **{k: np.asarray(v) for k, v in port_params(s1).items()})
    np.savez(root / "s2_init.npz", **{k: np.asarray(v) for k, v in
                                      bridge.stage2_trainer_from_jax(s2.g_params,
                                                                     s2.d_params).items()})
    b1, b2 = s1_batch(10), s2_batch(20)
    noise = noise_of(jax.random.PRNGKey(100), "fused")[0]
    np.savez(root / "s1_batch.npz", **b1)
    np.savez(root / "s2_batch.npz", **b2, noise=noise)

    # the CLI: one process to step 3 first (its ckpt-3 is resumed at 1x2)
    penn = root / "penn"
    make_synthetic_penn_tree(penn, n_train=2, n_test=1, frames_per_video=12)
    make_synthetic_pseudo_labels(penn, n_pts=4)
    one = train_main(cli_args(cli_yaml(root, penn, "log_one")))
    resume_dir = root / "log_resume" / "motion_generator"
    resume_dir.mkdir(parents=True)
    shutil.copytree(root / "log_one" / "motion_generator" / "ckpt-3", resume_dir / "ckpt-3")

    model2 = {k: list(v) if isinstance(v, tuple) else v for k, v in TRAIN_SMOKE.items()}
    spawns = {}
    for n_data, n_model in MESHES:
        job = {"model": n_model, "min_shard_dim": MIN_SHARD,
               "stage1": {"model": SMOKE1, "training": {"batch_size": 2,
                                                        "compute_dtype": "float32"},
                          "init": str(root / "s1_init.npz"), "batch": str(root / "s1_batch.npz"),
                          "vgg_width": VGG_WIDTH},
               "stage2": {"model": model2, "training": {"batch_size": B2,
                                                        "compute_dtype": "float32"},
                          "init": str(root / "s2_init.npz"), "batch": str(root / "s2_batch.npz")}}
        if (n_data, n_model) == (1, 2):
            job.update(cli=True,
                       cli_tp=cli_args(cli_yaml(root, penn, "log_tp"), "--mesh-model", "2"),
                       cli_resume=cli_args(cli_yaml(root, penn, "log_resume"),
                                           "--mesh-model", "2", "--max-steps", "5"))
        spawns[n_data, n_model] = Spawn(job, root / f"mesh{n_data}x{n_model}",
                                        n=n_data * n_model, worker=WORKER)
    yield dict(spawns=spawns, root=root, s1=s1, s2=s2, b1=b1, b2=b2, penn=penn, one=one)
    for spawn in spawns.values():
        spawn.kill()


_JAX = {}


def jax_step(tp, stage: int):
    """JAX's single-device 'fused' step on the global batch: (state, metrics)."""
    if stage not in _JAX:
        if stage == 1:
            state, metrics = jax.jit(jax_trainer().train_step)(tp["s1"], tp["b1"])
        else:
            step = jax.jit(JaxStage2Trainer(s2_jax_config()).train_step)
            state, metrics = step(tp["s2"], tp["b2"], jax.random.PRNGKey(100))
        _JAX[stage] = jax.device_get(state), {k: float(v) for k, v in metrics.items()}
    return _JAX[stage]


def port_arrays(state, stage: int) -> dict:
    if stage == 1:
        return {k: v.numpy() for k, v in port_params(state).items()}
    return {k: v.numpy() for k, v in bridge.stage2_trainer_from_jax(state.g_params,
                                                                     state.d_params).items()}


def assert_params_close_one_adam_step(got: dict, want: dict, lr: float) -> None:
    """tests/test_parallel.py::_assert_params_close_one_adam_step on the
    port's names: every element within 2.05 lr, the mean within 0.05 lr."""
    total = count = 0.0
    for name in want:
        d = np.abs(np.asarray(got[name], np.float32) - np.asarray(want[name], np.float32))
        assert d.max() <= 2.05 * lr, (name, float(d.max()))
        total += float(d.sum())
        count += d.size
    assert total / count < 0.05 * lr, f"mean param diff {total / count}"


def rank_full(arrays: dict, stage: int) -> dict:
    prefix = f"s{stage}_full/"
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("stage", [1, 2])
def test_tp_step_matches_jax(tp, stage, mesh):
    """One f32 step at the mesh against JAX's single-device step: metrics,
    parameters (one Adam step's bound) and BN statistics."""
    want_state, want_metrics = jax_step(tp, stage)
    arrays, infos = tp["spawns"][mesh].result()
    for k, v in want_metrics.items():
        np.testing.assert_allclose(infos[0][f"s{stage}_metrics"][k], v, err_msg=k, **METRIC_TOL)
    got, want = rank_full(arrays[0], stage), port_arrays(want_state, stage)
    params = [k for k in want if "running_" not in k]
    assert_params_close_one_adam_step(got, {k: want[k] for k in params}, LR)
    stats = [k for k in want if "running_" in k]
    assert len(stats) == (80 if stage == 1 else 0)
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STATS_TOL)
    assert int(got["step"]) == 1


def jax_moment(state, name: str) -> np.ndarray:
    """The optax Adam moment (mu / nu) of a port Adam array name, in the
    port's layout."""
    opt, _, rest = name.partition(".")
    rest, _, moment = rest.rpartition(".")
    leaf = rest.partition(".")[2]
    tree = getattr((state.g_opt_state if opt == "g_opt" else state.d_opt_state)[0],
                   {"exp_avg": "mu", "exp_avg_sq": "nu"}[moment])
    a = np.asarray(_at(tree, bridge.jax_path(leaf)), np.float32)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("stage", [1, 2])
def test_tp_gradients_match_jax(tp, stage, mesh):
    """The first Adam moment after one step is (1 - b1) times the step's
    gradient, so the gathered moments hold the gradients, at their scale
    (one Adam update is about lr * sign(g) and cannot show a gradient scaled
    by the axis size). Each tensor within 1e-3 of JAX's in relative L2 (the
    worst was 4e-5 in stage 1 and 5e-7 in stage 2 when this was written),
    but those whose gradient is zero in exact arithmetic: stage 1's conv
    biases before a train-mode BN and the heat map's bias, and the image
    encoder's unread last octave."""
    want_state, _ = jax_step(tp, stage)
    arrays, _ = tp["spawns"][mesh].result()
    got = rank_full(arrays[0], stage)
    names = [k for k in got if k.endswith(".exp_avg") and not k.endswith(
        (".conv.bias.exp_avg", ".heat.bias.exp_avg")) and ".image_encoder.trunk.down2." not in k
        and ".image_encoder.trunk.keep2." not in k]
    assert len(names) == (132 if stage == 1 else 20)
    worst = {}
    for name in names:
        want = jax_moment(want_state, name)
        worst[name] = float(np.linalg.norm(got[name] - want) / np.linalg.norm(want))
    assert max(worst.values()) <= 1e-3, max(worst.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("stage", [1, 2])
def test_ranks_hold_only_their_shards(tp, stage, mesh):
    """Each rank's sharded arrays (parameters, BN statistics, Adam moments)
    are its contiguous 1/M slice; the slices of the 'model' ranks join to the
    gathered array; the rule is JAX's over the whole train state; every
    replica ends with the same bits."""
    n_data, n_model = mesh
    arrays, infos = tp["spawns"][mesh].result()
    assert [i["coords"] for i in infos] == [[r // n_model, r % n_model] for r in range(len(infos))]
    rules = infos[0][f"s{stage}_rules"]
    full = rank_full(arrays[0], stage)
    state = jax.device_get(tp["s1"] if stage == 1 else tp["s2"])
    prefixes = ("stage1", "image_discriminator") if stage == 1 else ("stage2", "discriminator")
    assert set(rules) == jax_sharded_names(jax_specs(state, MIN_SHARD), full, *prefixes)
    assert len(rules) == (310 if stage == 1 else 48)
    for name, dim in rules.items():
        slices = [arrays[r][f"s{stage}_local/{name}"] for r in range(n_model)]
        assert all(list(s.shape) == infos[r][f"s{stage}_local_shapes"][name]
                   for r, s in enumerate(slices))
        assert slices[0].shape[dim] * n_model == full[name].shape[dim]
        np.testing.assert_array_equal(np.concatenate(slices, axis=dim), full[name], err_msg=name)
    for r in range(1, len(infos)):
        other = rank_full(arrays[r], stage)
        assert sorted(other) == sorted(full)
        assert all(np.array_equal(other[k], full[k]) for k in full)
        assert infos[r][f"s{stage}_metrics"] == infos[0][f"s{stage}_metrics"]


def ckpt_params(path: Path) -> dict:
    arrays = load_checkpoint(path)
    return {k: v for k, v in arrays.items() if k.startswith(("stage2.", "discriminator."))}


def test_cli_at_1x2_matches_one_process_and_resumes_both_ways(tp):
    """The stage-2 CLI with --mesh-model 2 for 3 steps: its full ckpt-3
    (written once, every array) against the one-process run's. Then to step
    5 from a ckpt-3 in turn: the one-process ckpt-3 at 1x2, the 1x2 ckpt-3 in
    one process, each against the one-process run resumed from its own."""
    _, infos = tp["spawns"][1, 2].result()
    root = tp["root"]
    one = root / "log_one" / "motion_generator"
    tp_dir = root / "log_tp" / "motion_generator"
    assert [i["cli_tp"]["start_step"] for i in infos] == [0, 0]
    assert sorted(p.name for p in tp_dir.iterdir() if p.name.startswith("ckpt-")) == [
        "ckpt-2", "ckpt-3"]
    got, want = load_checkpoint(tp_dir / "ckpt-3"), load_checkpoint(one / "ckpt-3")
    assert sorted(got) == sorted(want) and int(got["step"]) == 3
    assert all(got[k].shape == want[k].shape for k in want)
    assert_params_close_one_adam_step(got, ckpt_params(one / "ckpt-3"), LR)
    for k, v in tp["one"]["metrics"].items():
        np.testing.assert_allclose(infos[0]["cli_tp"]["metrics"][k], v, err_msg=k, **METRIC_TOL)

    back = root / "log_back" / "motion_generator"
    back.mkdir(parents=True)
    shutil.copytree(tp_dir / "ckpt-3", back / "ckpt-3")
    runs = [train_main(cli_args(cli_yaml(root, tp["penn"], log), "--max-steps", "5"))
            for log in ("log_back", "log_one")]
    assert [r["start_step"] for r in runs] == [3, 3]
    assert [i["cli_resume"]["start_step"] for i in infos] == [3, 3]
    want = ckpt_params(one / "ckpt-5")
    for got_dir in (back, root / "log_resume" / "motion_generator"):
        got = load_checkpoint(got_dir / "ckpt-5")
        assert int(got["step"]) == 5
        assert_params_close_one_adam_step(got, want, LR)


# ------------------------------------------------------ in-process pieces
def test_model_ranks_read_the_same_rows(tmp_path):
    """The pipeline shard of rank (d, m) is (d, D): the 'model' ranks of a
    coordinate get the same batches, so a step cannot be fed different rows
    through the pipeline; the data coordinates partition the epoch."""
    make_synthetic_penn_tree(tmp_path, n_train=3, n_test=1, frames_per_video=12)
    make_synthetic_pseudo_labels(tmp_path, n_pts=4)
    ds = SequenceDataset(str(tmp_path), "train", 4, 9, sequence_len=9, image_size=32)
    seen = {}
    for d in range(2):
        batches = []
        for m in range(2):
            shard = parallel.batch_shard(parallel.Mesh(2, 2, d, m))
            assert shard == (d, 2)
            pipe = HostDataPipeline(ds, 2, shuffle=True, repeat=False, seed=3, shard_id=shard[0],
                                    num_shards=shard[1], num_workers=1)
            batches.append([b["keypoints"] for b in pipe.batches()])
        assert len(batches[0]) == len(batches[1]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(*batches))
        seen[d] = batches[0]
    assert not any(np.array_equal(a, b) for a in seen[0] for b in seen[1])


ACCEPTED = {
    "model_axis": "parallel: {mesh_model: 2}",
    "mesh_2x2": "parallel: {mesh_data: 2, mesh_model: 2, min_shard_dim: 16}",
    "f32_reduce_with_tp": "training: {dp_grad_dtype: float32}\nparallel: {mesh_model: 4}",
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_config_accepts_what_jax_accepts(tmp_path, case):
    """A 'model' axis, as JAX takes it (the bf16 reduce with one is refused
    with JAX's message: test_torch_parallel.py's BAD_YAML)."""
    path = tmp_path / "c.yaml"
    path.write_text(ACCEPTED[case] + "\n")
    got, want = tcfgs.load_config(path), jax_load_config(path)
    assert dataclasses.asdict(got.parallel) == dataclasses.asdict(want.parallel)
    assert got.training.dp_grad_dtype == want.training.dp_grad_dtype


def test_shard_and_gather_in_one_process():
    """One process has no 'model' axis: the state passes through unsharded;
    the rule on shapes (conv kernels along O, other arrays along their last
    dim) matches kpvid_tpu's _leaf_spec on the Flax layout."""
    from kpvid_tpu.parallel.sharding import _leaf_spec

    for shape in [(1024, 512, 4, 4), (512, 1024, 4, 4), (2048,), (1104, 4096), (8, 2049),
                  (80, 4096), (3, 3), (), (64,), (1024, 3)]:
        flax = bridge.to_flax_layout(np.zeros(shape, np.float32)).shape
        for m, k in ((2, 1024), (2, 16), (4, 16), (3, 16), (1, 16)):
            dim = parallel.shard_dim(shape, m, k)
            spec = _leaf_spec(np.zeros(flax), m, k)
            assert (dim is not None) == (spec != P()), (shape, m, k)
            if dim is not None:
                assert shape[dim] == flax[-1]
    arrays = {"a": torch.arange(8.0)}
    assert parallel.shard_state(arrays, {"a": 0}, None) == arrays
    assert parallel.gather_state(arrays, {"a": 0}, None) == arrays
    shard = parallel.ModelShard(1, 2)
    assert torch.equal(shard.local(torch.arange(8.0).reshape(2, 4), 1),
                       torch.tensor([[2.0, 3.0], [6.0, 7.0]]))
    with pytest.raises(ValueError, match="1 processes not divisible by n_model=2"):
        parallel.make_mesh(n_model=2)
