"""The port's weights back to JAX, stage 1's frame cache, and the train
CLI's --profile-dir and --tensorboard, on the CPU.

- ``bridge.jax_path`` inverts the bridge's names: every path of both
  trainers' JAX trees comes back from the port's name for it, and
  ``bridge.to_jax`` gives back the generation trees ``from_jax`` took;
- ``tools/export_jax_checkpoint.py`` turns a port trainer ``ckpt-2`` of each
  stage into a JAX ``GANTrainState`` that ``kpvid_tpu/utils/checkpoint.py``
  restores with every leaf the port's, bit for bit (the int32 step and
  optax's counts too); one more step in JAX and in the port from it agrees
  (stage 2: parameters atol 2e-6, or 2 lr where the step's gradient is below
  1e-6; stage 1: tests/test_torch_stage1.py's bounds for a later step), and
  JAX's ``generate`` on the two exports matches the port's on the two
  checkpoints (images atol 1e-4, keypoints 1e-5);
- a trainer checkpoint taken before any update holds a fresh Adam state,
  and the learning rate follows the optimizer's own update count;
- ``ImagePairDataset`` with ``decode_cache_mb`` gives the uncached bytes
  over two epochs, and JAX's cached dataset's; a pipeline of more worker
  threads than cores shares one cache and gives the uncached batches; the
  LRU keeps its byte budget (a copy of tests/test_data.py's test);
- the stage-1 CLI with the cache, ``--profile-dir`` and ``--tensorboard``
  ends 16 steps with the bits of the plain run, writes a trace of steps 10
  to 14, and event files with scalars and images; ``MetricLogger`` as
  tests/test_logging.py holds JAX's, and a TensorBoard that cannot import
  fails the logger.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu.data import ImagePairDataset as JaxImagePairDataset
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator
from kpvid_tpu.losses import synthesize_vgg19_params as jax_synthesize_vgg19_params
from kpvid_tpu.train.stage1 import Stage1Trainer as JaxStage1Trainer
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer
from kpvid_tpu.utils.checkpoint import _key_name, merge_restore, restore_checkpoint
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from kpvid_tpu_torch.data import HostDataPipeline, ImagePairDataset
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.losses import synthesize_vgg19_params
from kpvid_tpu_torch.serve import load_generator_parameters
from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer
from kpvid_tpu_torch.train.state import update_count
from kpvid_tpu_torch.utils import MetricLogger
from test_torch_stage1 import randomize

REPO = Path(__file__).resolve().parent.parent
LR = 1e-4
PARAM_ATOL = 2e-6
VGG_WIDTH = 16
B = 2
YAML = """
paths: {{data_dir: '{root}/penn', log_dir: '{log}', vggnet: '{root}/no_vgg19.npy'}}
training: {{compute_dtype: float32, batch_size: 2, n_steps: 16, checkpoint_interval: 100,
            summary_interval: 8, test_interval: 100, log_interval: 8}}
model: {{n_pts: 4, n_action: 3, cell_info: [32, 32], vae_dim: 8, n_future_frames: 8,
         image_size: 32, heatmap_size: 8, encoder_filters: 8, translator_filters: 16,
         pose_decoder_filters: 16, discriminator_filters: 8}}
data: {{num_workers: 2, sequence_len: 9, eval_batch_size: 2{data}}}
"""


def _flat(tree) -> dict:
    return {tuple(_key_name(k) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _config(root: Path, log: str = "log", data: str = "") -> Path:
    path = root / f"{log}.yaml"
    path.write_text(YAML.format(root=root, log=root / log, data=data))
    return path


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return _config(tmp_path_factory.mktemp("cfg"))


@pytest.fixture(scope="module")
def jax_states(cfg_path):
    """JAX's trainer states at smoke widths, every BN statistic, BN scale and
    bias drawn at random."""
    jcfg = jax_load_config(cfg_path)
    rng = np.random.default_rng(7)
    s1 = JaxStage1Trainer(jcfg, jax_synthesize_vgg19_params(max_width=VGG_WIDTH)).init_state(
        jax.random.PRNGKey(0))
    s1 = s1.replace(g_params=randomize(s1.g_params, rng),
                    batch_stats=randomize(s1.batch_stats, rng),
                    d_params=randomize(s1.d_params, rng))
    s2 = JaxStage2Trainer(jcfg).init_state(jax.random.PRNGKey(0))
    s2 = s2.replace(g_params=randomize(s2.g_params, rng), d_params=randomize(s2.d_params, rng))
    return {1: jax.device_get(s1), 2: jax.device_get(s2)}


def _port_params(state, stage: int) -> dict:
    if stage == 1:
        return bridge.stage1_trainer_from_jax(state.g_params, state.d_params, state.batch_stats)
    return bridge.stage2_trainer_from_jax(state.g_params, state.d_params)


# ------------------------------------------------------------ the bridge
@pytest.mark.parametrize("stage", [1, 2])
def test_jax_path_inverts_the_bridge(jax_states, stage):
    """Every JAX path of the trainer's g_params, batch_stats and d_params
    comes back from the port's name for it."""
    state = jax_states[stage]
    want = set()
    for col in ("g_params", "batch_stats", "d_params"):
        want |= set(_flat(getattr(state, col)))
    got = {bridge.jax_path(name.split(".", 1)[1]) for name in _port_params(state, stage)}
    assert got == want and len(want) > 10


def test_to_jax_inverts_from_jax(jax_states):
    """The generation trees: from_jax then to_jax is the identity, leaf for
    leaf and bit for bit."""
    s1, s2 = jax_states[1], jax_states[2]
    stage1 = {"params": s1.g_params, "batch_stats": s1.batch_stats}
    got1, got2 = bridge.to_jax(bridge.from_jax(stage1, s2.g_params))
    want1, want2 = _flat(stage1), {k: v for k, v in _flat(s2.g_params).items()
                                   if k[0] in bridge.STAGE2_DECODE_MODULES}
    for got, want in ((_flat(got1), want1), (_flat(got2), want2)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(want[k])), k


# ------------------------------------------------------ port -> JAX export
def _batches(stage: int, n: int) -> list[dict]:
    rng = np.random.default_rng(40 + stage)
    if stage == 1:
        return [{k: rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
                 for k in ("image", "future_image")} for _ in range(n)]
    out = []
    for _ in range(n):
        start = rng.uniform(-0.6, 0.6, (B, 1, 4, 2))
        seq = np.clip(start + rng.normal(0, 0.05, (B, 9, 4, 2)).cumsum(axis=1), -1, 1)
        out.append({"keypoints": seq[:, 0].astype(np.float32),
                    "real_seq": seq[:, 1:].astype(np.float32),
                    "action_code": np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]})
    return out


def _noise(key) -> np.ndarray:
    return np.asarray(jax.random.normal(key, (B, 8), jax.numpy.float32))


def _port_trainer(stage: int, cfg_path: Path):
    tcfg = tcfgs.load_config(cfg_path)
    if stage == 1:
        return Stage1Trainer(tcfg, synthesize_vgg19_params(max_width=VGG_WIDTH), device="cpu")
    return Stage2Trainer(tcfg, device="cpu")


def _port_step(trainer, stage: int, batch: dict, key):
    return trainer.train_step(batch) if stage == 1 else trainer.train_step(batch, _noise(key))


@pytest.fixture(scope="module")
def exported(tmp_path_factory, jax_states, cfg_path):
    """A port trainer ckpt-2 of each stage (two fused steps from the JAX
    states), and tools/export_jax_checkpoint.py's JAX checkpoint of it."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import export_jax_checkpoint
    finally:
        sys.path.remove(str(REPO / "tools"))
    root = tmp_path_factory.mktemp("export")
    out = {"root": root}
    for stage in (1, 2):
        trainer = _port_trainer(stage, cfg_path)
        trainer.load_parameters(_port_params(jax_states[stage], stage))
        for i, batch in enumerate(_batches(stage, 2)):
            _port_step(trainer, stage, batch, jax.random.PRNGKey(i))
        name = "detector_translator" if stage == 1 else "motion_generator"
        ckpt = save_checkpoint(root / "port", name, 2, trainer.state_arrays())
        path = export_jax_checkpoint.main(["--config", str(cfg_path), "--checkpoint",
                                           str(root / "port" / name),
                                           "--log-dir", str(root / "jax")])
        out[stage] = {"trainer": trainer, "ckpt": ckpt, "jax": path}
    return out


@pytest.mark.parametrize("stage", [1, 2])
def test_export_restores_with_the_ports_leaves(exported, stage):
    """JAX's restore of the export: the GANTrainState's fields, each leaf the
    port's array bit for bit, the step and optax's four counts int32."""
    e = exported[stage]
    name = "detector_translator" if stage == 1 else "motion_generator"
    assert e["jax"] == (exported["root"] / "jax" / name / "ckpt-2").resolve()
    restored = restore_checkpoint(e["jax"])
    arrays = load_checkpoint(e["ckpt"])
    assert sorted(restored) == ["batch_stats", "d_opt_state", "d_params", "g_opt_state",
                                "g_params", "step"]
    assert np.asarray(restored["step"]).dtype == np.int32 and int(restored["step"]) == 2
    fields = _flat(bridge.stage1_trainer_to_jax(arrays) if stage == 1
                   else bridge.stage2_trainer_to_jax(arrays))
    got = _flat(restored)
    assert sorted(got) == sorted(fields)
    for k, v in fields.items():
        assert np.asarray(got[k]).dtype == v.dtype and np.array_equal(got[k], v), k
    counts = [k for k in got if k[-1] == "count"]
    assert len(counts) == 4 and all(int(got[k]) == 2 and got[k].dtype == np.int32 for k in counts)
    # the port's own arrays, by name: the generator, a BN statistic, an Adam moment
    g = "stage1" if stage == 1 else "stage2"
    for pname, val in arrays.items():
        if pname.startswith(g + ".") and val.ndim != 4:
            path = ("g_params",) + bridge.jax_path(pname[len(g) + 1:])
            if path[-1] in bridge.BATCH_STATS:
                path = ("batch_stats",) + path[1:]
            assert np.array_equal(got[path], val), pname
    first = next(k for k in arrays if k.startswith(f"g_opt.{g}.") and k.endswith(".exp_avg"))
    mu = ("g_opt_state", "0", "mu") + bridge.jax_path(first[len(f"g_opt.{g}."):-len(".exp_avg")])
    assert got[mu].any() and np.array_equal(bridge.to_flax_layout(arrays[first]), got[mu])


def _jax_trainer(stage: int, cfg_path: Path):
    jcfg = jax_load_config(cfg_path)
    if stage == 1:
        return JaxStage1Trainer(jcfg, jax_synthesize_vgg19_params(max_width=VGG_WIDTH))
    return JaxStage2Trainer(jcfg)


@pytest.mark.parametrize("stage", [1, 2])
def test_one_more_step_from_the_export_matches(exported, cfg_path, stage):
    """JAX resumes the export as train.py does (merge_restore into its
    init_state) and takes a third step; the port takes it from its ckpt-2."""
    e = exported[stage]
    jt = _jax_trainer(stage, cfg_path)
    state, n = merge_restore(jt.init_state(jax.random.PRNGKey(3)), restore_checkpoint(e["jax"]))
    assert n == len(jax.tree.leaves(state)) and int(state.step) == 2
    batch, key = _batches(stage, 3)[2], jax.random.PRNGKey(2)
    args = (state, batch) if stage == 1 else (state, batch, key)
    want_state, want_metrics = jax.jit(jt.train_step)(*args)
    want_state = jax.device_get(want_state)

    trainer = _port_trainer(stage, cfg_path)
    trainer.load_state_arrays(load_checkpoint(e["ckpt"]))
    grads = {}
    apply = trainer._apply

    def recording_apply(opt, params, g):
        for p, x in zip(params, g):
            grads[id(p)] = x.clone()
        apply(opt, params, g)

    trainer._apply = recording_apply
    metrics = _port_step(trainer, stage, batch, key)
    assert trainer.step == int(want_state.step) == 3 and update_count(trainer.g_opt) == 3
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=1e-4,
                                   err_msg=k)
    want = _port_params(want_state, stage)
    state_dict = trainer.model.state_dict()
    beyond = total = 0
    for name, p in trainer.model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        tiny = grads[id(p)].abs() < 1e-6
        if stage == 2:
            bound = torch.where(tiny, torch.full_like(diff, 2 * LR),
                                torch.full_like(diff, PARAM_ATOL))
            assert bool((diff <= bound).all()), (name, float(diff.max()))
            continue
        # stage 1 (tests/test_torch_stage1.py): biases whose gradient is zero
        # in exact arithmetic within 2.5 lr; elsewhere 2e-6 (2.5 lr where the
        # gradient is below 1e-6), but for at most 2% of the elements (here
        # counted over the whole model: one of a BN scale's 8 is 12%), which
        # a later step takes up to lr / 2 past it where a gradient's sign
        # turned over
        if name.endswith((".conv.bias", ".heat.bias")):
            tiny = torch.ones_like(tiny)
        bound = torch.where(tiny, torch.full_like(diff, 2.5 * LR),
                            torch.full_like(diff, PARAM_ATOL))
        beyond += int((diff > bound).sum())
        total += diff.numel()
        assert bool((diff <= bound + LR / 2).all()), (name, float(diff.max()))
    assert beyond <= 0.02 * total, (beyond, total)
    for name in state_dict:
        if "running_" in name:
            np.testing.assert_allclose(state_dict[name].numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_jax_generate_on_the_exports_matches_the_port(exported, cfg_path):
    """JAX's FinalGenerator on the two exported states against the port's on
    the two checkpoints it exported from (f32, the same z)."""
    s1, s2 = (restore_checkpoint(exported[s]["jax"]) for s in (1, 2))
    jgen = JaxFinalGenerator(jax_load_config(cfg_path))
    gen = FinalGenerator(tcfgs.load_config(cfg_path), device="cpu")
    gen.load_parameters(load_generator_parameters(
        gen.model.state_dict(), str(exported[1]["ckpt"]), str(exported[2]["ckpt"])))
    rng = np.random.default_rng(8)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(3, dtype=np.float32)[[1, 0]]
    z = rng.standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda a, b, c, d, e: jgen.generate(a, b, c, d, None, z=e))(
        {"params": s1["g_params"], "batch_stats": s1["batch_stats"]}, s2["g_params"], im, act, z)
    got = gen.generate(im, act, z)
    for key, atol in (("current_points", 1e-5), ("future_points", 1e-5), ("pred_im_seq", 1e-4),
                      ("mask", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol,
                                   err_msg=key)


def test_a_checkpoint_before_any_update_holds_a_fresh_adam(cfg_path):
    """state_arrays before the first update: zero moments and step 0 for
    every parameter (what an import writes); loaded back, the next update
    takes lr(0) at any train step, and each update after it the schedule at
    the optimizer's count."""
    trainer = _port_trainer(2, cfg_path)
    trainer.step = 1000
    arrays = trainer.state_arrays()
    opt = {k: v for k, v in arrays.items() if k.startswith(("g_opt.", "d_opt."))}
    assert len(opt) == 3 * sum(1 for _ in trainer.model.parameters())
    assert not any(v.any() for v in opt.values())
    other = _port_trainer(2, cfg_path)
    other.load_state_arrays({k: v.numpy() for k, v in arrays.items()})
    assert other.step == 1000 and update_count(other.g_opt) == 0
    rates = []
    for i, batch in enumerate(_batches(2, 2)):
        other.train_step(batch, _noise(jax.random.PRNGKey(i)))
        rates.append(other.g_opt.param_groups[0]["lr"])
    assert rates == [other.lr_schedule(0), other.lr_schedule(1)]
    assert other.step == 1002 and update_count(other.d_opt) == 2


# ----------------------------------------------------------- frame cache
@pytest.fixture(scope="module")
def pair_tree(tmp_path_factory):
    """Videos of 14 frames, so that t + d wraps around often."""
    from kpvid_tpu_torch.data import make_synthetic_penn_tree

    root = tmp_path_factory.mktemp("pairs")
    make_synthetic_penn_tree(root, n_train=3, n_test=2, frames_per_video=14)
    return root


@pytest.mark.parametrize("subset", ["train", "test"])
def test_frame_cache_gives_the_uncached_and_jaxs_bytes(pair_tree, subset):
    """Two epochs of samples: the cached dataset's bytes are the uncached
    one's and JAX's cached dataset's; the second epoch hits."""
    kw = dict(image_size=32)
    plain = ImagePairDataset(str(pair_tree), subset, **kw)
    cached = ImagePairDataset(str(pair_tree), subset, decode_cache_mb=64, **kw)
    jax_cached = JaxImagePairDataset(str(pair_tree), subset, decode_cache_mb=64, **kw)
    n = len(plain)
    for epoch in range(2):
        for idx in range(n):
            seed = epoch * n + idx
            want = plain.sample(idx, np.random.default_rng(seed))
            got = cached.sample(idx, np.random.default_rng(seed))
            ref = jax_cached.sample(idx, np.random.default_rng(seed))
            for k in want:
                assert got[k].tobytes() == want[k].tobytes() == ref[k].tobytes(), (seed, k)
    stats = cached.cache.stats()
    assert stats == jax_cached.cache.stats()
    assert stats["hits"] > 0 and stats["hits"] + stats["misses"] == 4 * n
    assert plain.cache is None


def test_frame_cache_shared_by_more_workers_than_cores(pair_tree):
    """One cache under 4x the cores' worker threads with a short switch
    interval: the batches are the uncached pipeline's, every lookup counted."""
    n_workers = 4 * (os.cpu_count() or 1)
    kw = dict(batch_size=4, shuffle=True, repeat=True, num_workers=n_workers, seed=3)
    plain = HostDataPipeline(ImagePairDataset(str(pair_tree), "train", image_size=32), **kw)
    ds = ImagePairDataset(str(pair_tree), "train", image_size=32, decode_cache_mb=64)
    cached = HostDataPipeline(ds, **kw)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a, b = plain.batches(), cached.batches()
        for _ in range(12):
            want, got = next(a), next(b)
            assert all(got[k].tobytes() == want[k].tobytes() for k in want)
        a.close()
        b.close()
    finally:
        sys.setswitchinterval(interval)
    stats = ds.cache.stats()
    assert stats["hits"] > 0 and stats["hits"] + stats["misses"] >= 2 * 12 * 4
    assert stats["entries"] <= sum(ds._n_frames(rel) for rel, _ in ds.videos)


def test_frame_cache_lru_budget():
    """A copy of tests/test_data.py's: 1 MiB entries under a 3 MB budget."""
    import PIL.Image

    from kpvid_tpu_torch.data.cache import FrameCache

    cache = FrameCache(3)
    arr = np.zeros((512, 1024 // 2, 4), np.uint8)  # 1 MiB
    for i in range(8):
        cache.get(("v", i), lambda: PIL.Image.fromarray(arr[..., :3]))
    s = cache.stats()
    assert s["entries"] <= 4 and s["bytes"] <= 4 * arr[..., :3].nbytes
    # the most recent key is still resident (a hit, not a re-decode)
    cache.get(("v", 7), lambda: (_ for _ in ()).throw(AssertionError("evicted")))


def test_config_reads_decode_cache_mb(tmp_path):
    path = _config(tmp_path, data=", decode_cache_mb: 256")
    assert tcfgs.load_config(path).data.decode_cache_mb == 256
    assert jax_load_config(path).data.decode_cache_mb == 256
    assert tcfgs.Config().data.decode_cache_mb == 0


# ---------------------------------------- the CLI's profiler and TensorBoard
@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """python -m kpvid_tpu_torch.train --mode detector_translator, 16 steps
    on a synthetic tree, once with the frame cache, --profile-dir and
    --tensorboard and once without them."""
    from kpvid_tpu_torch.train import main

    root = tmp_path_factory.mktemp("cli")
    plain = _config(root, "plain")
    cached = _config(root, "cached", data=", decode_cache_mb: 64")
    args = ["--mode", "detector_translator", "--device", "cpu"]
    runs = {"root": root}
    runs["cached"] = main(args + ["--synthetic", "--config", str(cached), "--tensorboard",
                                  "--profile-dir", str(root / "prof")])
    runs["plain"] = main(args + ["--config", str(plain)])
    return runs


def test_cli_with_the_cache_ends_with_the_plain_runs_bits(cli_runs):
    root = cli_runs["root"]
    want = load_checkpoint(root / "plain" / "detector_translator" / "ckpt-16")
    got = load_checkpoint(root / "cached" / "detector_translator" / "ckpt-16")
    assert sorted(got) == sorted(want) and int(got["step"]) == 16
    assert all(np.array_equal(got[k], want[k]) for k in want)
    stats = cli_runs["cached"]["frame_cache"]
    assert stats["hits"] > 0 and stats["misses"] > 0 and stats["bytes"] > 0
    assert cli_runs["plain"]["frame_cache"] is None and cli_runs["plain"]["profile_trace"] is None


def test_cli_profile_dir_writes_a_trace_of_steps_10_to_14(cli_runs):
    trace = cli_runs["cached"]["profile_trace"]
    assert trace == cli_runs["root"] / "prof" / "detector_translator_rank0.pt.trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::convolution") for e in events)
    # five steps: two Adam updates each
    adam = [e for e in events if e.get("name") == "Optimizer.step#Adam.step"]
    assert len(adam) == 10


def test_cli_profile_dir_trace_names_each_steps_data_wait_and_step(cli_runs):
    events = json.loads(cli_runs["cached"]["profile_trace"].read_text())["traceEvents"]

    def ranges(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X" and e.get("name") == name)

    waits, steps = ranges("kpvid.train.data_wait"), ranges("kpvid.train.step")
    assert len(waits) == 5 and len(steps) == 5
    for (w0, w1), (s0, s1) in zip(waits, steps):
        assert w0 <= w1 <= s0 <= s1  # each step's batch, then its step
    # each step's two Adam updates inside its own kpvid.train.step
    for a0, a1 in ranges("Optimizer.step#Adam.step"):
        assert sum(s0 <= a0 and a1 <= s1 for s0, s1 in steps) == 1
    assert all(sum(s0 <= a0 and a1 <= s1 for a0, a1 in ranges("Optimizer.step#Adam.step")) == 2
               for s0, s1 in steps)


def test_cli_tensorboard_writes_scalars_and_images(cli_runs):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ck = cli_runs["root"] / "cached" / "detector_translator"
    train = EventAccumulator(str(ck / "train"), size_guidance={"images": 0}).Reload()
    assert {"loss_D", "loss_G", "lr"} <= set(train.Tags()["scalars"])
    assert [e.step for e in train.Scalars("loss_G")] == [0, 8]
    assert len(train.Tags()["images"]) == 2 * 7 and train.Images(train.Tags()["images"][0])
    test = EventAccumulator(str(ck / "test")).Reload()
    assert "psnr" in test.Tags()["scalars"]
    assert not (cli_runs["root"] / "plain" / "detector_translator" / "train").exists()


def test_metric_logger_tensorboard(tmp_path):
    """As tests/test_logging.py holds JAX's: JSONL, PNGs (two per name) and
    an event file carrying the images; a disabled logger opens no writer."""
    ml = MetricLogger(tmp_path, "stage", tensorboard=True)
    ml.log_metrics("train", 5, {"loss_D": 0.5, "loss_G": 1.5})
    ml.log_images("train", 5, {"im": np.random.default_rng(0).uniform(-1, 1, (3, 16, 16, 3)),
                               "mask": np.random.default_rng(1).uniform(0, 1, (3, 16, 16, 1))})
    ml.close()
    assert json.loads((tmp_path / "stage" / "train_metrics.jsonl").read_text())["loss_D"] == 0.5
    assert len(list((tmp_path / "stage" / "train_images").glob("*.png"))) == 4
    events = list((tmp_path / "stage" / "train").glob("events.out*"))
    assert events and events[0].stat().st_size > 500
    off = MetricLogger(tmp_path / "off", "stage", tensorboard=True, enabled=False)
    off.log_metrics("train", 1, {"loss": 1.0})
    off.close()
    assert not (tmp_path / "off").exists()


def test_tensorboard_that_cannot_import_fails_the_logger(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        MetricLogger(tmp_path, "stage", tensorboard=True)
    MetricLogger(tmp_path, "stage").close()  # not asked for: not imported
    shutil.rmtree(tmp_path / "stage")
