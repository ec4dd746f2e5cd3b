"""The port's multi-process data parallelism against kpvid_tpu's, on the CPU.

Two processes of tests/torch_dp_worker.py join through the KPVID_* env
contract (gloo on the CPU, a free localhost port) and run, in f32 at smoke
widths, from the JAX trainers' initial states carried across by the bridge:

- the data-parallel stage-1 and stage-2 'fused' steps, each rank on its
  contiguous rows of the global batch (stage 1: local batch 1 of 2; stage 2:
  2 of 4), against JAX's single-device step on the global batch after 1 and
  3 steps: metrics rtol 1e-4; stage 2's parameters within 1e-5
  (tests/test_dp_step.py:159-165); stage 1's parameters and BN statistics
  under tests/test_torch_stage1.py's per-element exceptions, which this
  run's gradients (the reduced ones of the first update) decide;
- with the bf16 all-reduce, one step against JAX's ``make_dp_reduce_step``
  on 2 CPU devices: metrics atol 1e-4, parameters within 2.05 lr (Adam's
  first update is lr * sign where bf16 rounding flips a near-zero
  gradient), and not bit-equal to the f32 reduce's;
- stage 2 with grad_accum 2 under DP against JAX's full-batch step
  (test_dp_step.py:190): parameters within 1e-5;
- the collectives of one step from a profile (parallel/inventory.py): bf16
  halves the gradient bytes and nothing else changes;
- ``python -m kpvid_tpu_torch.train --mode motion_generator --synthetic``
  on 2 processes at local batch 1 (the strided shards keep the
  single-process order, as tests/mp_worker.py explains) against one process
  at batch 2: the checkpoint's parameters within 1e-5, one writer;
- the labeler on 2 processes against JAX's detect (1e-5), and evaluate on 2
  processes against the one-process PNG tree, byte for byte.

Stage 1 with grad_accum 2 is held against JAX's ``train_step_accum`` in this
process. Each spawn has its own time limit; a rank that dies must make the
other's barrier fail, not hang.
"""

import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu.data import HostDataPipeline as JaxPipe
from kpvid_tpu.data import VideoFramesDataset as JaxVideoFramesDataset
from kpvid_tpu.losses import synthesize_vgg19_params as jax_synthesize_vgg19_params
from kpvid_tpu.models import Stage1Generator as JaxStage1Generator
from kpvid_tpu.parallel import make_dp_reduce_step as jax_make_dp_reduce_step
from kpvid_tpu.parallel import make_mesh as jax_make_mesh
from kpvid_tpu.parallel import shard_batch, shard_state
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer
from kpvid_tpu_torch import bridge, evaluate, parallel
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.checkpoint import load_checkpoint, save_parameters
from kpvid_tpu_torch.data import (
    HostDataPipeline,
    make_synthetic_penn_tree,
    make_synthetic_pseudo_labels,
)
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.losses import synthesize_vgg19_params
from kpvid_tpu_torch.train import Stage1Trainer
from kpvid_tpu_torch.train import main as train_main
from test_torch_final import SMOKE as EVAL_SMOKE
from test_torch_stage1 import (
    LR,
    METRIC_RTOL,
    PARAM_ATOL,
    SMOKE1,
    STATS_ATOL,
    UNUSED,
    VGG_WIDTH,
    jax_trainer,
    port_params,
    randomize,
)
from test_torch_stage1 import jax_config as s1_jax_config
from test_torch_stage1 import make_batch as s1_batch
from test_torch_stage1 import port_config as s1_port_config
from test_torch_train import B as B2
from test_torch_train import TRAIN_SMOKE, noise_of
from test_torch_train import jax_config as s2_jax_config
from test_torch_train import make_batch as s2_batch

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dp_worker.py"
SPAWN_TIMEOUT_S = 240
S2_PARAM_ATOL = 1e-5
BF16_ENVELOPE = 2.05 * LR
LABEL_SMOKE = dict(n_pts=4, heatmap_size=8, encoder_filters=8, translator_filters=16,
                   pose_decoder_filters=16)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Spawn:
    """``n`` coordinated worker processes (``worker``, default
    tests/torch_dp_worker.py) on a job; ``result()`` waits for them (at most
    SPAWN_TIMEOUT_S from the start, then kills them all) and asserts that
    each exited 0."""

    def __init__(self, job: dict, out: Path, n: int = 2, worker: Path = WORKER):
        out.mkdir(parents=True, exist_ok=True)
        job_path = out / "job.json"
        job_path.write_text(json.dumps(dict(job, out=str(out))))
        port = free_port()
        self.out, self.logs, self.procs = out, [], []
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for pid in range(n):
            env = dict(os.environ, KPVID_COORDINATOR=f"localhost:{port}",
                       KPVID_NUM_PROCESSES=str(n), KPVID_PROCESS_ID=str(pid),
                       KPVID_COLLECTIVE_TIMEOUT="60", OMP_NUM_THREADS="2")
            log = out / f"rank{pid}.log"
            self.logs.append(log)
            with log.open("w") as f:  # logs to files: a full pipe would block a rank
                self.procs.append(subprocess.Popen([sys.executable, str(worker), str(job_path)],
                                                   cwd=REPO, env=env, stdout=f,
                                                   stderr=subprocess.STDOUT))
        self._codes = None

    def wait(self) -> list[int]:
        if self._codes is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            finally:
                self.kill()
            self._codes = [p.returncode for p in self.procs]
        return self._codes

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def result(self) -> tuple[list, list]:
        codes = self.wait()
        for code, log in zip(codes, self.logs):
            assert code == 0, f"worker exited {code}:\n{log.read_text()[-4000:]}"
        arrays = [dict(np.load(self.out / f"rank{r}.npz")) for r in range(len(codes))]
        infos = [json.loads((self.out / f"rank{r}.json").read_text()) for r in range(len(codes))]
        return arrays, infos


def stage1_init():
    jt = jax_trainer()
    state = jt.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    return jax.device_get(state.replace(g_params=randomize(state.g_params, rng),
                                        batch_stats=randomize(state.batch_stats, rng),
                                        d_params=randomize(state.d_params, rng)))


def stage2_init():
    return jax.device_get(JaxStage2Trainer(s2_jax_config()).init_state(jax.random.PRNGKey(0)))


def numpy_of(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def cli_yaml(root: Path) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    path = root / "train.yaml"
    path.write_text(json.dumps({
        "paths": {"data_dir": str(root / "penn"), "log_dir": str(root / "log")},
        "training": {"compute_dtype": "float32", "batch_size": 2, "n_steps": 3,
                     "checkpoint_interval": 2, "summary_interval": 1, "test_interval": 2,
                     "log_interval": 1},
        "model": {"n_pts": 4, "n_action": 9, "cell_info": [32, 32], "vae_dim": 8,
                  "n_future_frames": 8, "image_size": 32, "heatmap_size": 8,
                  "encoder_filters": 8, "translator_filters": 16, "pose_decoder_filters": 16},
        "data": {"num_workers": 2, "sequence_len": 9},
    }))
    return path


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Writes the inputs, starts the 2 ranks, and returns what the JAX side
    and the one-process runs need while they work."""
    root = tmp_path_factory.mktemp("dp")
    s1, s2 = stage1_init(), stage2_init()
    np.savez(root / "s1_init.npz", **numpy_of(port_params(s1)))
    np.savez(root / "s2_init.npz", **numpy_of(bridge.stage2_trainer_from_jax(s2.g_params,
                                                                              s2.d_params)))
    s1_batches = [s1_batch(10 + i) for i in range(4)]
    s2_batches = [s2_batch(20 + i) for i in range(4)]
    s2_noise = [noise_of(jax.random.PRNGKey(100 + i), "fused")[0] for i in range(4)]
    np.savez(root / "s1_batches.npz", **{f"{i}/{k}": v for i, b in enumerate(s1_batches)
                                         for k, v in b.items()})
    np.savez(root / "s2_batches.npz", **{f"{i}/{k}": v for i, b in enumerate(s2_batches)
                                         for k, v in b.items()},
             **{f"{i}/noise": n for i, n in enumerate(s2_noise)})

    # the labeler's stage-1 parameters, JAX's randomized init of its generator
    gen = JaxStage1Generator(dtype=jax.numpy.float32, upsample_mode="fused", **LABEL_SMOKE)
    dummy = jax.numpy.zeros((1, 32, 32, 3), jax.numpy.float32)
    v = jax.jit(lambda r: gen.init(r, dummy, dummy, train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng)}
    save_parameters(root / "label_s1.npz", bridge.from_jax(v))
    make_synthetic_penn_tree(root / "label_penn", n_train=2, n_test=1)
    (root / "label.yaml").write_text(json.dumps({
        "paths": {"data_dir": str(root / "label_penn")}, "training": {"compute_dtype": "float32"},
        "model": dict(LABEL_SMOKE, image_size=32), "data": {"labeler_chunk": 32}}))

    # evaluate: 3 test videos at batch 1, so the ranks take 2 and 1 batches
    tcfg = tcfgs.Config(model=tcfgs.ModelConfig(**EVAL_SMOKE)).validate()
    final = FinalGenerator(tcfg, device="cpu")
    params = randomize_final_params(final.init_parameters(0))
    save_parameters(root / "eval_params.npz", params)
    make_synthetic_penn_tree(root / "eval_penn", n_train=1, n_test=3, frames_per_video=12)
    make_synthetic_pseudo_labels(root / "eval_penn", n_pts=EVAL_SMOKE["n_pts"])
    (root / "eval.yaml").write_text(json.dumps({
        "paths": {"data_dir": str(root / "eval_penn")}, "training": {"compute_dtype": "float32"},
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in EVAL_SMOKE.items()},
        "data": {"num_workers": 2, "eval_batch_size": 1,
                 "sequence_len": EVAL_SMOKE["n_future_frames"] + 1}}))

    def eval_args(save_dir):
        return ["--config", str(root / "eval.yaml"), "--checkpoint_stage1",
                str(root / "eval_params.npz"), "--checkpoint_stage2",
                str(root / "eval_params.npz"), "--save_dir", str(save_dir), "--seed", "5",
                "--device", "cpu", "--png-workers", "2"]

    model1 = dict(SMOKE1)
    model2 = {k: list(v) if isinstance(v, tuple) else v for k, v in TRAIN_SMOKE.items()}
    job = {
        "stage1": {"model": model1, "training": {"batch_size": 2, "compute_dtype": "float32"},
                   "init": str(root / "s1_init.npz"), "batches": str(root / "s1_batches.npz"),
                   "vgg_width": VGG_WIDTH},
        "stage2": {"model": model2, "training": {"batch_size": B2, "compute_dtype": "float32"},
                   "init": str(root / "s2_init.npz"), "batches": str(root / "s2_batches.npz")},
        "stage2_accum": {"model": model2,
                         "training": {"batch_size": B2, "compute_dtype": "float32"},
                         "init": str(root / "s2_init.npz"),
                         "batches": str(root / "s2_batches.npz")},
        "train_args": ["--mode", "motion_generator", "--synthetic", "--device", "cpu",
                       "--config", str(cli_yaml(root / "cli2"))],
        "label_args": ["--config", str(root / "label.yaml"), "--checkpoint",
                       str(root / "label_s1.npz"), "--device", "cpu"],
        "evaluate_args": eval_args(root / "eval_2proc"),
    }
    spawn = Spawn(job, root / "ranks")
    yield dict(spawn=spawn, root=root, s1=s1, s2=s2, s1_batches=s1_batches,
               s2_batches=s2_batches, s2_noise=s2_noise, label_gen=gen, label_vars=v,
               eval_args=eval_args)
    spawn.kill()


def randomize_final_params(params: dict) -> dict:
    """BN statistics, BN affine and biases drawn at random, as the other
    tests randomize the JAX trees."""
    rng = np.random.default_rng(11)
    out = {}
    for k, v in params.items():
        a = v.numpy().copy()
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, a.shape)
        elif k.endswith(("running_mean", "bias")):
            a = rng.normal(0.0, 0.1, a.shape)
        elif k.endswith("bn.weight"):
            a = rng.uniform(0.5, 1.5, a.shape)
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


_JAX_RUNS = {}


def jax_stage1_run(dp):
    """JAX's single-device stage-1 'fused' step on the global batch: states
    after 1 and 3 steps, metrics of each step."""
    if "s1" not in _JAX_RUNS:
        step = jax.jit(jax_trainer().train_step)
        state, states, history = dp["s1"], [], []
        for i in range(3):
            state, metrics = step(state, dp["s1_batches"][i])
            states.append(jax.device_get(state))
            history.append({k: float(v) for k, v in metrics.items()})
        _JAX_RUNS["s1"] = states, history
    return _JAX_RUNS["s1"]


def jax_stage2_run(dp):
    if "s2" not in _JAX_RUNS:
        step = jax.jit(JaxStage2Trainer(s2_jax_config()).train_step)
        state, states, history = dp["s2"], [], []
        for i in range(3):
            state, metrics = step(state, dp["s2_batches"][i], jax.random.PRNGKey(100 + i))
            states.append(jax.device_get(state))
            history.append({k: float(v) for k, v in metrics.items()})
        _JAX_RUNS["s2"] = states, history
    return _JAX_RUNS["s2"]


def jax_dp_bf16_step(dp, stage: int):
    """One step of JAX's shard_map DP step with the bf16 all-reduce on 2 CPU
    devices."""
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    if stage == 1:
        cfg = s1_jax_config(dp_grad_dtype="bfloat16")
        step = jax_make_dp_reduce_step(cfg, mesh, stage=1, donate=False,
                                       vgg_params=jax_synthesize_vgg19_params(max_width=VGG_WIDTH))
        state, metrics = step(shard_state(mesh, dp["s1"]), shard_batch(mesh, dp["s1_batches"][0]))
    else:
        cfg = s2_jax_config(dp_grad_dtype="bfloat16")
        step = jax_make_dp_reduce_step(cfg, mesh, stage=2, donate=False)
        state, metrics = step(shard_state(mesh, dp["s2"]), shard_batch(mesh, dp["s2_batches"][0]),
                              jax.random.PRNGKey(100))
    return jax.device_get(state), {k: float(v) for k, v in metrics.items()}


def rank_state(arrays: dict, tag: str) -> dict:
    prefix = f"{tag}/"
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
            if k.startswith(prefix)}


def check_stage1_params(got: dict, want_state, init_state, grads: dict, n_steps: int) -> None:
    """tests/test_torch_stage1.py's bounds: BN statistics atol 1e-5;
    parameters atol 2e-6 but where Adam's first update is a sign step (a
    first-step gradient below 1e-6, or a bias whose gradient is zero in
    exact arithmetic): 2.5 lr per step; up to 2% of a tensor beyond that
    and all within lr / 2 per later step more."""
    want, init = port_params(want_state), port_params(init_state)
    assert sorted(got) == sorted(want)
    for name, val in got.items():
        diff = (val - want[name]).abs()
        if "running_" in name:
            assert bool((diff <= STATS_ATOL).all()), (name, float(diff.max()))
            assert not torch.equal(val, init[name]), name
            continue
        sign_step = grads[name].abs() < 1e-6
        if name.endswith((".conv.bias", ".heat.bias")):
            sign_step = torch.ones_like(sign_step)
        bound = torch.where(sign_step, torch.full_like(diff, 2.5 * LR * n_steps),
                            torch.full_like(diff, PARAM_ATOL))
        assert int((diff > bound).sum()) <= 0.02 * diff.numel(), name
        assert bool((diff <= bound + LR / 2 * (n_steps - 1)).all()), (name, float(diff.max()))


def check_metrics(arrays: dict, tag: str, history: list, **tol) -> None:
    for i, want in enumerate(history):
        for k, v in want.items():
            np.testing.assert_allclose(float(arrays[f"{tag}_m{i}_{k}"]), v, err_msg=f"{i} {k}",
                                       **tol)


def max_diff(got: dict, want: dict) -> float:
    return max(float((got[k] - torch.as_tensor(np.asarray(want[k]))).abs().max()) for k in want)


# ------------------------------------------------------------ the trainers
@pytest.mark.parametrize("n_steps", [1, 3])
def test_stage1_dp_steps_match_jax(dp, n_steps):
    """Sync-BN (forward and backward through the all-reduce), the f32
    gradient all-reduce and the metric mean against JAX's single-device
    step on the global batch."""
    states, history = jax_stage1_run(dp)
    a0 = dp["spawn"].result()[0][0]
    check_metrics(a0, "s1_f32", history[:n_steps], rtol=METRIC_RTOL)
    check_stage1_params(rank_state(a0, f"s1_f32_after{n_steps}"), states[n_steps - 1], dp["s1"],
                        rank_state(a0, "s1_f32_grad"), n_steps)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_stage2_dp_steps_match_jax(dp, n_steps):
    """The global-batch noise sliced by rank, the f32 gradient all-reduce
    and the metric mean against JAX's single-device step: parameters within
    1e-5."""
    states, history = jax_stage2_run(dp)
    a0 = dp["spawn"].result()[0][0]
    check_metrics(a0, "s2_f32", history[:n_steps], rtol=METRIC_RTOL, atol=1e-6)
    want = bridge.stage2_trainer_from_jax(states[n_steps - 1].g_params,
                                          states[n_steps - 1].d_params)
    got = rank_state(a0, f"s2_f32_after{n_steps}")
    assert sorted(got) == sorted(want)
    assert max_diff(got, want) < S2_PARAM_ATOL


@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_reduce_matches_jax_dp_step(dp, stage):
    """One step with the bf16 gradient all-reduce against JAX's
    make_dp_reduce_step: metrics atol 1e-4, every parameter within 2.05 lr,
    and not the f32 reduce's bits."""
    want_state, want_metrics = jax_dp_bf16_step(dp, stage)
    a0 = dp["spawn"].result()[0][0]
    tag = f"s{stage}_bf16"
    check_metrics(a0, tag, [want_metrics], rtol=2e-4, atol=1e-4)
    got = rank_state(a0, f"{tag}_after1")
    if stage == 1:
        want = port_params(want_state)
    else:
        want = bridge.stage2_trainer_from_jax(want_state.g_params, want_state.d_params)
    assert sorted(got) == sorted(want)
    params = [k for k in want if "running_" not in k]
    assert max_diff({k: got[k] for k in params}, {k: want[k] for k in params}) <= BF16_ENVELOPE
    stats = [k for k in want if "running_" in k]
    if stats:
        assert max_diff({k: got[k] for k in stats}, {k: want[k] for k in stats}) <= STATS_ATOL
    f32 = rank_state(a0, f"s{stage}_f32_after1")
    assert any(not torch.equal(got[k], f32[k]) for k in params)  # bf16 did round


def test_stage2_grad_accum_under_dp_matches_the_full_batch_step(dp):
    """grad_accum 2 on 2 ranks (micros of 1 row): each rank accumulates its
    micros and the average is reduced once; with no BN and row-indexed noise
    it is JAX's full-batch 'fused' step."""
    states, history = jax_stage2_run(dp)
    a0 = dp["spawn"].result()[0][0]
    check_metrics(a0, "s2_accum", history[:1], rtol=METRIC_RTOL, atol=1e-6)
    want = bridge.stage2_trainer_from_jax(states[0].g_params, states[0].d_params)
    assert max_diff(rank_state(a0, "s2_accum_after1"), want) < S2_PARAM_ATOL


def test_stage1_grad_accum_matches_jax_train_step_accum(dp):
    """Stage 1 with grad_accum 2 in one process against JAX's
    train_step_accum, on 4 rows: micros of 2, the batch of the other
    stage-1 tests. Each micro normalizes with its own statistics and the
    running statistics take the EMA twice. (With micros of one image the
    losses still agree to 5e-7, but about 0.1% of the weights take their
    first update with the other sign on each side: BN statistics over a
    single image leave the step's gradient more sensitive to rounding than
    the check's bounds allow.)"""
    batch = {k: np.concatenate([b[k] for b in dp["s1_batches"][:2]])
             for k in ("image", "future_image")}
    jt = jax_trainer(grad_accum=2)
    state, metrics = jax.jit(jt.train_step_accum)(dp["s1"], batch)
    trainer = Stage1Trainer(s1_port_config(grad_accum=2),
                            synthesize_vgg19_params(max_width=VGG_WIDTH), device="cpu")
    trainer.load_parameters(port_params(dp["s1"]))
    reduce, first = trainer._reduce_grads, []
    trainer._reduce_grads = lambda grads: first.append(reduce(grads)) or first[-1]
    got_metrics = trainer.train_step_accum(batch)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_metrics[k]), float(v), rtol=METRIC_RTOL, err_msg=k)
    names = ([f"stage1.{n}" for n in trainer._g_names]
             + [f"image_discriminator.{n}" for n in trainer._d_names])
    grads = dict(zip(names, first[0] + first[1]))
    check_stage1_params({k: v.detach() for k, v in trainer.model.state_dict().items()},
                        jax.device_get(state), dp["s1"], grads, 1)
    with pytest.raises(ValueError, match="divisible by grad_accum=2"):
        trainer.train_step_accum({k: v[:3] for k, v in batch.items()})


def test_replicas_stay_equal(dp):
    """Both ranks end every run with the same bits in every array: the
    reductions leave each replica the same update."""
    arrays, infos = dp["spawn"].result()
    assert sorted(arrays[0]) == sorted(arrays[1])
    differ = [k for k in arrays[0] if "_grad/" not in k and not np.array_equal(arrays[0][k],
                                                                              arrays[1][k])]
    assert not differ, differ[:5]
    assert [i["rank"] for i in infos] == [0, 1]
    assert all(i["world"] == 2 and i["multiproc"] for i in infos)


@pytest.mark.parametrize("stage", [1, 2])
def test_inventory_bf16_halves_the_gradient_bytes(dp, stage):
    """One profiled step: the same all-reduces with either dtype (one bucket
    per network, one of the metrics and, in stage 1, two per BN layer:
    sync-BN's forward and backward); bf16 carries 2 bytes per parameter
    less, nothing else changes (tests/test_dp_step.py:327)."""
    inv = dp["spawn"].result()[1][0]["inventory"]
    f32, bf16 = inv[f"s{stage}_f32"], inv[f"s{stage}_bf16"]
    assert set(f32["counts"]) == set(bf16["counts"]) == {"all_reduce"}
    n_bn = n_unread = 0
    if stage == 1:
        trainer = Stage1Trainer(s1_port_config(), synthesize_vgg19_params(max_width=VGG_WIDTH),
                                device="cpu")
        bns = [k for k in trainer.model.state_dict() if k.endswith("running_mean")]
        n_bn, n_unread = len(bns), sum(k.startswith(UNUSED) for k in bns)
    assert (f32["counts"]["all_reduce"] == bf16["counts"]["all_reduce"]
            == 3 + 2 * n_bn - n_unread)
    assert f32["bytes"]["all_reduce"] - bf16["bytes"]["all_reduce"] == 2 * f32["n_params"]
    assert "c10::BFloat16" in bf16["dtypes"]["all_reduce"]
    assert f32["dtypes"]["all_reduce"] == ["float"]


# ------------------------------------------------------------- the CLIs
def test_train_cli_on_two_processes_matches_one(dp, tmp_path):
    """The stage-2 CLI on 2 processes at local batch 1 against one process
    at batch 2: the same checkpoints (parameters within 1e-5), written once;
    metric lines once; no image summaries. The one process runs without
    image summaries too: as in JAX's train.py, a summary with images splits
    the key chain for its noise, and several processes write none."""
    arrays, infos = dp["spawn"].result()
    one = train_main(["--mode", "motion_generator", "--synthetic", "--device", "cpu",
                      "--no-images", "--config", str(cli_yaml(tmp_path))])
    two_dir = dp["root"] / "cli2" / "log" / "motion_generator"
    assert [i["train"]["end_step"] for i in infos] == [3, 3]
    got, want = load_checkpoint(two_dir / "ckpt-3"), load_checkpoint(
        tmp_path / "log" / "motion_generator" / "ckpt-3")
    assert sorted(got) == sorted(want) and int(got["step"]) == 3
    params = [k for k in want if k.startswith(("stage2.", "discriminator."))]
    assert max(float(np.abs(got[k] - want[k]).max()) for k in params) < S2_PARAM_ATOL
    assert sorted(p.name for p in two_dir.iterdir() if p.name.startswith("ckpt-")) == [
        "ckpt-2", "ckpt-3"]
    assert (two_dir / "train_metrics.jsonl").read_text().count("\n") == 3
    assert (two_dir / "test_metrics.jsonl").read_text().count("\n") == 2
    assert not (two_dir / "train_images").exists()
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(infos[0]["train"]["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_labeler_on_two_processes_matches_jax(dp):
    """Each rank labels its stride of each split into the shared directory;
    every video's labels are JAX's detect within 1e-5."""
    infos = dp["spawn"].result()[1]
    tree = dp["root"] / "label_penn"
    gen, v = dp["label_gen"], dp["label_vars"]
    detect = jax.jit(lambda v, im: gen.apply(v, im, method=gen.detect))
    n_videos = n_frames = 0
    for subset in ("train", "test"):
        for vid, n, frames in JaxVideoFramesDataset(str(tree), subset, 32).iter_videos():
            padded = np.zeros((64,) + frames.shape[1:], np.float32)
            padded[:n] = frames  # one shape: one compile
            got = np.load(tree / "pseudo_labels" / f"{vid:04d}.npy")
            assert got.shape == (n, 4, 2) and got.dtype == np.float32
            np.testing.assert_allclose(got, np.asarray(detect(v, padded))[:n], rtol=0, atol=1e-5)
            n_videos += 1
            n_frames += n
    assert [i["label"]["videos"] for i in infos] == [2, 1]  # train 0 / 1, test 0
    assert sum(i["label"]["frames"] for i in infos) == n_frames and n_videos == 3


def test_evaluate_on_two_processes_writes_the_one_process_tree(dp):
    """Batch-granularity shards and the global batch index's latents: the
    PNG tree of one process, byte for byte."""
    infos = dp["spawn"].result()[1]
    stats = evaluate.main(dp["eval_args"](dp["root"] / "eval_1proc"))
    assert stats["batches"] == 3
    assert [i["evaluate"]["batches"] for i in infos] == [2, 1]

    def files(root):
        return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.png"))}

    got, want = files(dp["root"] / "eval_2proc"), files(dp["root"] / "eval_1proc")
    assert sorted(got) == sorted(want) and len(want) == 3 * (2 + 5 * EVAL_SMOKE["n_future_frames"])
    assert not [k for k in want if got[k] != want[k]]


def test_a_dead_rank_fails_the_barrier(tmp_path):
    """Rank 1 leaves without a word: rank 0's barrier raises (within the
    collective timeout) instead of hanging."""
    spawn = Spawn({"die": True}, tmp_path)
    codes = spawn.wait()
    assert codes[1] == 0 and codes[0] != 0
    assert "kpvid_test_die" in spawn.logs[0].read_text()


# ----------------------------------------------------- in-process pieces
class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, idx, rng):
        return {"idx": np.array(idx), "x": rng.standard_normal(2).astype(np.float32)}


@pytest.mark.parametrize("granularity", ["sample", "batch"])
def test_pipeline_shards_match_jax(granularity):
    """Every shard's index stream, shuffled and repeating from a resume
    point or one pass in order, is JAX's; the shards partition an epoch."""
    for shuffle, repeat, start in ((True, True, 5), (False, False, 0)):
        seen = []
        for shard in range(3):
            kw = dict(shuffle=shuffle, repeat=repeat, seed=4, shard_id=shard, num_shards=3,
                      start_sample=start, shard_granularity=granularity)
            got = list(itertools.islice(HostDataPipeline(_Indexed(13), 2, **kw)._index_stream(),
                                        40))
            want = list(itertools.islice(JaxPipe(_Indexed(13), 2, **kw)._index_stream(), 40))
            assert got == want
            seen += [i for e, i in got if e == 0]
            if not repeat:
                bat = [b["idx"].tolist() for b in HostDataPipeline(_Indexed(13), 2, **kw).batches()]
                assert bat == [b["idx"].tolist() for b in JaxPipe(_Indexed(13), 2, **kw).batches()]
        if not repeat:
            assert sorted(seen) == list(range(13))
    with pytest.raises(ValueError, match="shard_id 3 not in"):
        HostDataPipeline(_Indexed(4), 2, shard_id=3, num_shards=3)
    with pytest.raises(ValueError, match="shard_granularity"):
        HostDataPipeline(_Indexed(4), 2, shard_granularity="row")


BAD_YAML = {
    "grad_accum_zero": "training: {grad_accum: 0}",
    "grad_accum_divides": "training: {batch_size: 6, grad_accum: 4}",
    "grad_accum_fused": "training: {batch_size: 8, grad_accum: 2, gan_step_mode: two_batch}",
    "dp_grad_dtype": "training: {dp_grad_dtype: float16}",
    "bf16_with_tp": "training: {dp_grad_dtype: bfloat16}\nparallel: {mesh_model: 2}",
    "mesh_data": "parallel: {mesh_data: 0}",
}


@pytest.mark.parametrize("case", sorted(BAD_YAML))
def test_config_refusals_carry_jax_messages(tmp_path, case):
    path = tmp_path / "bad.yaml"
    path.write_text(BAD_YAML[case] + "\n")
    with pytest.raises(ValueError) as want:
        jax_load_config(path)
    with pytest.raises(ValueError) as got:
        tcfgs.load_config(path)
    assert str(got.value) == str(want.value)


def test_config_reads_the_parallel_fields(tmp_path):
    """grad_accum, dp_grad_dtype, mesh_data and min_shard_dim as JAX reads
    them; a 'model' axis as JAX takes it."""
    path = tmp_path / "c.yaml"
    path.write_text("training: {batch_size: 8, grad_accum: 2, dp_grad_dtype: bfloat16}\n"
                    "parallel: {mesh_data: 4, min_shard_dim: 512}\n")
    got, want = tcfgs.load_config(path), jax_load_config(path)
    assert dataclasses.asdict(got.parallel) == dataclasses.asdict(want.parallel)
    for f in ("grad_accum", "dp_grad_dtype"):
        assert getattr(got.training, f) == getattr(want.training, f)
    path.write_text("parallel: {mesh_model: 2}\n")
    assert jax_load_config(path).parallel.mesh_model == 2
    assert tcfgs.load_config(path).parallel.mesh_model == 2


def test_single_process_defaults_and_refusals(monkeypatch):
    """Without the KPVID_* environment nothing is joined: rank 0 of 1, the
    whole batch, barriers pass; the mesh refuses a shape that the process
    count does not fill; the DP step refuses what JAX's refuses (the bf16
    reduce with a 'model' axis), and needs a process group."""
    for var in ("KPVID_COORDINATOR", "KPVID_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.maybe_initialize("cpu") is False
    assert parallel.world() == (0, 1) and parallel.is_primary()
    assert parallel.local_batch_size(6) == 6
    parallel.barrier("single")
    assert parallel.make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="1 processes not divisible by n_model=2"):
        parallel.make_mesh(n_model=2)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        parallel.make_mesh(n_data=2)
    cfg = s1_port_config()
    with pytest.raises(ValueError, match="pure-DP"):
        parallel.make_dp_reduce_step(s1_port_config(dp_grad_dtype="bfloat16"), 2,
                                     mesh=parallel.Mesh(1, 2))
    with pytest.raises(ValueError, match="unknown gan_step_mode"):
        parallel.make_dp_reduce_step(cfg, 2, mode="alternate")
    with pytest.raises(RuntimeError, match="needs a process group"):
        parallel.make_dp_reduce_step(cfg, 2)
    monkeypatch.setenv("KPVID_COORDINATOR", "localhost:1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.maybe_initialize("cuda")
