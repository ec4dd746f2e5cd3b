"""Train stage 1 (the keypoint detector and translator) or stage 2 (the
motion generator).

    python -m kpvid_tpu_torch.train --mode detector_translator \
        --config kpvid_tpu_torch/configs/penn.yaml
    python -m kpvid_tpu_torch.train --mode motion_generator \
        --config kpvid_tpu_torch/configs/penn.yaml

(``main`` here; ``train/__main__.py`` runs it.) Counterpart of the JAX
package's ``train.py``. Stage 1 trains on frame pairs of the Penn-Action tree
(``ImagePairDataset``) with the VGG19 weights of ``paths.vggnet``, or
synthesized frozen stand-ins with a warning when that file is absent;
``--synthetic`` writes a synthetic tree first. Stage 2 reads
``<data_dir>/pseudo_labels/*.npy`` (``python -m
kpvid_tpu_torch.make_pseudo_labels`` writes them; ``--synthetic`` writes a
synthetic tree and random-walk labels instead). Batches of the train split
go through ``HostDataPipeline`` (seeded, augmented, copied to the card ahead
of the step) into the trainer's step of ``training.gan_step_mode``.

Each ``log_interval`` it logs the console line, each ``summary_interval``
the train metrics (``{log_dir}/{mode}/train_metrics.jsonl``) and the summary
images, each ``test_interval`` a sweep of the test split
(``test_metrics.jsonl``), and each ``checkpoint_interval`` (and at the end)
a checkpoint ``{log_dir}/{mode}/ckpt-{step}/`` written in the background.
``ckpt-{step}`` holds the state after the update of loop step ``step``, as
JAX's does. With ``training.resume`` a run continues from the newest
checkpoint: the data stream from sample ``step * batch_size`` (twice that in
'two_batch'), and the key chain of JAX's ``train.py`` fast-forwarded to that
step, so that stage 2's VAE noise is the uninterrupted run's; the CLI asks
cuDNN for its deterministic algorithms, so that a resumed stage-1 run
repeats the bits too.

The keys are JAX's (utils/jax_random.py, drawn on the host), so one
``training.seed`` gives the weights and noise of JAX's ``train.py``:
``rng = PRNGKey(seed)``, ``rng, init_rng = split(rng)`` for
``init_state(init_rng)``, then ``rng, step_rng = split(rng)`` on every
step (stage 1 draws nothing from it). Stage 2 draws its noise from
``step_rng`` as :func:`step_noise` says; at a summary step with images (one
process) ``rng, viz_rng = split(rng)`` for the summary's noise; the test
sweep splits the chain's current ``rng`` once per batch without advancing
it. JAX's own resume restarts the chain from ``PRNGKey(seed)``; this one
continues it. The trainer
runs on the card and raises without one (``--device cpu`` runs on the CPU).
Stage 1's train split decodes through the frame cache when
``data.decode_cache_mb`` > 0 (data/cache.py; the same bytes). As in JAX's
``train.py``, ``--tensorboard`` also writes TensorBoard event files, and
``--profile-dir`` a ``torch.profiler`` trace (the host's ops and, on the
card, the kernels) of loop steps ``start + 10`` to ``start + 14``.

Data parallelism, one process per card: launch N copies with the KPVID_*
environment (``KPVID_COORDINATOR=host:port KPVID_NUM_PROCESSES=N
KPVID_PROCESS_ID=i``) or under torchrun with ``KPVID_MULTIHOST=auto``
(parallel/distributed.py). Every process builds the same replica from
``training.seed`` (or the same ``ckpt-N``, read after a barrier), feeds its
strided shard of the data, ``batch_size / N`` rows a step, and runs the
data-parallel step (parallel/dp_step.py: gradients averaged in
``training.dp_grad_dtype``, stage-1 sync-BN, stage 2's noise drawn for the
global batch and sliced by rank). A process group of one (the KPVID_*
environment with N = 1) runs the same data-parallel step. With
``training.grad_accum`` K > 1 the 'fused' step accumulates K micros of the
local batch.

Tensor parallelism: ``--mesh-model M`` (or ``parallel.mesh_model``) lays
the N = D x M processes out as a ('data', 'model') mesh, rank ``r`` at
``(r // M, r % M)`` (parallel/mesh.py). The M processes of a data
coordinate read the same shard of the data (``d`` of ``D``), ``batch_size
/ D`` rows a step, and hold only their shards of the arrays that
``parallel.min_shard_dim`` selects (train/state.py): the reductions run
over the 'data' axis. ``--mesh-data`` must be N / M. The checkpoints hold
full arrays, so a run resumes on any mesh or in one process; a save joins
the shards, a collective that every process enters.

Only the first process writes the synthetic tree, logs, metrics and
checkpoints; the others wait at barriers. Image summaries are skipped, and
every process sweeps the whole test split on its own (rank 0 logs it).
"""

from __future__ import annotations

import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from ..utils import jax_random

MODES = ("detector_translator", "motion_generator")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch trainer")
    parser.add_argument("--mode", type=str, required=True, choices=MODES)
    parser.add_argument("--config", type=str, required=True, help="YAML config path")
    parser.add_argument("--synthetic", action="store_true",
                        help="write a synthetic tree (and, for stage 2, labels) into data_dir "
                             "first")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this step (overrides training.n_steps)")
    parser.add_argument("--no-images", action="store_true",
                        help="skip the image summaries at summary_interval")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also write TensorBoard event files (JSONL metrics always on)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 10-14 here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--mesh-data", type=int, default=None,
                        help="size of the 'data' axis (overrides parallel.mesh_data; default: "
                             "every process)")
    parser.add_argument("--mesh-model", type=int, default=None,
                        help="size of the 'model' (tensor-parallel) axis (overrides "
                             "parallel.mesh_model)")
    return parser


def step_noise(step_key, n: int, rows: int, vae_dim: int) -> np.ndarray:
    """The VAE noise of one stage-2 train step from its key: [n, rows,
    vae_dim] f32, as JAX's steps draw it. n = 1 ('fused', its grad_accum
    and data-parallel forms): ``normal(step_key, (rows, vae_dim))`` for the
    global batch; n = 2 ('fused_dg', 'two_batch'): the D and G draws from
    the two keys of ``split(step_key)``."""
    keys = [step_key] if n == 1 else jax_random.split(step_key)
    return np.stack([jax_random.normal(k, (rows, vae_dim)) for k in keys])


def init_key(seed: int) -> np.ndarray:
    """The key JAX's ``train.py`` initializes the trainer with for ``seed``:
    ``split(PRNGKey(seed))[1]``."""
    return jax_random.split(jax_random.PRNGKey(seed))[1]


def key_chain(seed: int, start_step: int, summary_split) -> np.ndarray:
    """The key of JAX's ``train.py`` chain before loop step ``start_step``:
    from ``split(PRNGKey(seed))[0]`` through the splits of the earlier steps
    (``summary_split(step)``: whether that step split a summary key off
    too)."""
    rng = jax_random.split(jax_random.PRNGKey(seed))[0]
    for step in range(start_step):
        rng = jax_random.split(rng)[0]
        if summary_split(step):
            rng = jax_random.split(rng)[0]
    return rng


def vgg_params(config):
    """The VGG19 weights of ``paths.vggnet``, or JAX's synthesized stand-ins
    (with a warning) when the file is absent."""
    from ..losses import load_vgg19_params, synthesize_vgg19_params
    from ..utils import logger

    path = Path(config.paths.vggnet)
    if path.exists():
        return load_vgg19_params(str(path))
    logger.warning("vgg19.npy not found at %s - using synthesized frozen weights (fine for "
                   "smoke tests, not for real training)", path)
    return synthesize_vgg19_params()


def main(argv=None) -> dict:
    """Train; returns the trainer and the run's steps, last metrics and seconds."""
    args = build_parser().parse_args(argv)
    # the process group first, on this rank's card: a no-op unless the
    # KPVID_* environment asks for it
    from ..parallel import (
        barrier,
        batch_shard,
        is_primary,
        local_batch_size,
        make_dp_reduce_step,
        make_mesh,
        maybe_initialize,
        select_step,
        world,
    )

    multiproc = maybe_initialize(args.device)
    dp = torch.distributed.is_initialized()
    from ..checkpoint import AsyncCheckpointManager, latest_checkpoint, load_checkpoint
    from ..configs import load_config
    from ..data import HostDataPipeline, device_prefetch
    from ..device import resolve_device
    from ..utils import MetricLogger, Throughput, get_n_colors, logger, setup_console_logging

    setup_console_logging()
    device = resolve_device(args.device)
    # cuDNN's deterministic algorithms: a resumed run repeats the bits of the
    # uninterrupted one (stage 1's convolutions; stage 2 runs none)
    torch.backends.cudnn.deterministic = True
    config = load_config(args.config)
    t_cfg, m_cfg = config.training, config.model
    p_cfg = config.parallel
    n_model = args.mesh_model if args.mesh_model is not None else p_cfg.mesh_model
    n_data = args.mesh_data if args.mesh_data is not None else p_cfg.mesh_data
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    bs = t_cfg.batch_size
    local_bs = local_batch_size(bs, mesh.data)
    if t_cfg.grad_accum > 1 and local_bs % t_cfg.grad_accum:
        raise ValueError(
            f"per-shard batch ({bs}/{mesh.data}={local_bs}) must be divisible by "
            f"grad_accum ({t_cfg.grad_accum}): accumulation splits each shard's rows"
        )
    rank, n_proc = world()
    data_dir = config.paths.data_dir
    stage1 = args.mode == "detector_translator"
    if args.synthetic:
        from ..data import make_synthetic_penn_tree, make_synthetic_pseudo_labels

        if is_primary():  # one writer on a shared filesystem
            make_synthetic_penn_tree(data_dir)
            if not stage1:
                make_synthetic_pseudo_labels(data_dir, n_pts=m_cfg.n_pts)
        barrier("kpvid_train_synthetic")
    vgg = None
    if stage1:
        from ..data import ImagePairDataset
        from ..eval.visualize import stage1_summary_images
        from .stage1 import Stage1Trainer

        train_ds = ImagePairDataset(data_dir, "train", image_size=m_cfg.image_size,
                                    decode_cache_mb=config.data.decode_cache_mb,
                                    native_ops=config.data.native_ops)
        test_ds = ImagePairDataset(data_dir, "test", image_size=m_cfg.image_size,
                                   native_ops=config.data.native_ops)
        vgg = vgg_params(config)
    else:
        from ..data import SequenceDataset
        from ..eval.visualize import stage2_summary_images
        from .stage2 import Stage2Trainer

        kw = dict(n_pts=m_cfg.n_pts, n_action=m_cfg.n_action,
                  sequence_len=config.data.sequence_len, image_size=m_cfg.image_size,
                  native_ops=config.data.native_ops)
        train_ds = SequenceDataset(data_dir, "train", **kw)
        test_ds = SequenceDataset(data_dir, "test", **kw)
    mode = t_cfg.gan_step_mode
    if dp:  # a process group, of one process or more: the data-parallel step
        trainer, step_fn = make_dp_reduce_step(config, 1 if stage1 else 2, mesh, vgg,
                                               device=device)
        logger.info("multi-process step on %d process(es), mesh %dx%d (data x model), rank %d "
                    "at (%d, %d) on %s, local batch %d, gradient all-reduce in %s, %d arrays "
                    "sharded", n_proc, mesh.data, mesh.model, rank, mesh.d, mesh.m, device,
                    local_bs, t_cfg.dp_grad_dtype, len(trainer.array_rules))
    else:
        trainer = (Stage1Trainer(config, vgg, device=device) if stage1
                   else Stage2Trainer(config, device=device))
        step_fn = select_step(trainer, mode, t_cfg.grad_accum)
    trainer.load_parameters(trainer.init_parameters(init_key(t_cfg.seed)))
    ckpt_dir = Path(config.paths.log_dir) / args.mode
    if t_cfg.resume:
        barrier("kpvid_train_restore")  # every rank reads the same ckpt-N
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            trainer.load_state_arrays(load_checkpoint(latest))
            logger.info("resumed from %s (step %d)", latest, trainer.step)

    metric_logger = MetricLogger(config.paths.log_dir, args.mode, tensorboard=args.tensorboard,
                                 enabled=is_primary())
    ckpt_manager = (AsyncCheckpointManager(config.paths.log_dir, args.mode,
                                           keep=t_cfg.keep_checkpoints)
                    if is_primary() else None)
    throughput = Throughput()
    n_steps = args.max_steps if args.max_steps is not None else t_cfg.n_steps
    two_batch = mode == "two_batch"
    fused_dg = mode == "fused_dg"
    start_step = trainer.step
    images = not args.no_images and not multiproc
    # train.py's chain before start_step: a summary split where stage 2 wrote images
    rng = key_chain(t_cfg.seed, start_step, lambda step: images and not stage1
                    and step % t_cfg.summary_interval == 0)
    shard_id, num_shards = batch_shard(mesh)  # the 'model' ranks of a coordinate: one shard
    train_pipe = HostDataPipeline(
        train_ds, local_bs, shuffle=True, repeat=True, num_workers=config.data.num_workers,
        prefetch=config.data.prefetch, seed=t_cfg.seed, shard_id=shard_id,
        num_shards=num_shards, start_sample=start_step * local_bs * (2 if two_batch else 1),
    )
    logger.info("training %s from step %d to %d on %s", args.mode, start_step, n_steps, device)
    colors = get_n_colors(m_cfg.n_pts)
    batches = train_pipe.batches()
    train_iter = device_prefetch(batches, device, size=config.data.prefetch)

    def train_step(step_rng, batch: dict) -> dict:
        step_batches = (batch, next(train_iter)) if two_batch else (batch,)
        if stage1:
            return step_fn(*step_batches)
        # the global batch's noise on every rank; the trainer takes its rows
        noise = step_noise(step_rng, 2 if two_batch or fused_dg else 1, bs, m_cfg.vae_dim)
        return step_fn(*step_batches, *noise)

    def summary_images(viz_rng, batch: dict) -> dict:
        if stage1:
            return stage1_summary_images(trainer, batch, colors)
        noise = jax_random.normal(viz_rng, (min(2, bs), m_cfg.vae_dim))
        return stage2_summary_images(trainer, batch, colors, noise)

    def save(step: int) -> None:
        # every rank: joining the shards is a collective; the first writes
        arrays = trainer.state_arrays()
        if ckpt_manager is not None:
            ckpt_manager.save(step, arrays)

    metrics = {}
    profiler = trace = None
    t_start = time.perf_counter()
    try:
        for step in range(start_step, n_steps):
            # JAX's window: loop steps start + 10 to start + 14
            if args.profile_dir and step == start_step + 10:
                profiler = start_profiler(device)
            elif profiler is not None and step == start_step + 15:
                trace, profiler = stop_profiler(profiler, device, args.profile_dir, args.mode,
                                                rank), None
                logger.info("profiler trace written to %s", args.profile_dir)
            rng, step_rng = jax_random.split(rng)
            t0 = time.perf_counter()
            batch = next(train_iter)
            metrics = train_step(step_rng, batch)
            throughput.update(bs)

            if step % t_cfg.log_interval == 0:  # the host waits for the card here only
                ex_s, s_b = throughput.rates()
                if step == start_step:
                    s_b = time.perf_counter() - t0
                metric_logger.log_console(step, float(metrics["loss_D"]),
                                          float(metrics["loss_G"]), ex_s, s_b)
                throughput.reset()
            if step % t_cfg.summary_interval == 0:
                metric_logger.log_metrics("train", step, metrics)
                # (several processes: the summary's forward would run on one
                # rank's rows alone; skipped, the scalars are still logged)
                if images:
                    viz_rng = None
                    if not stage1:  # train.py: rng, viz_rng = split(rng)
                        rng, viz_rng = jax_random.split(rng)
                    metric_logger.log_images("train", step, summary_images(viz_rng, batch))
            if step % t_cfg.checkpoint_interval == 0 and step > start_step:
                save(step)
            if step % t_cfg.test_interval == 0:
                run_test_sweep(trainer, test_ds, config, step, metric_logger, rng, stage1)
        save(n_steps)
        if ckpt_manager is not None:
            ckpt_manager.wait()
        barrier("kpvid_train_done")  # the checkpoints are on disk for every rank
    finally:
        if profiler is not None:  # the run ended inside the window
            trace = stop_profiler(profiler, device, args.profile_dir, args.mode, rank)
        train_iter.close()
        batches.close()
        metric_logger.close()
    seconds = time.perf_counter() - t_start
    frame_cache = train_ds.cache.stats() if getattr(train_ds, "cache", None) else None
    if frame_cache is not None:
        logger.info("decoded-frame cache: %s", frame_cache)
    logger.info("done at step %d", n_steps)
    return {"trainer": trainer, "start_step": start_step, "end_step": n_steps,
            "metrics": {k: float(v) for k, v in metrics.items()}, "seconds": seconds,
            "checkpoint_dir": str(ckpt_dir), "frame_cache": frame_cache, "profile_trace": trace}


def start_profiler(device: torch.device):
    """A running torch.profiler over the host's ops and, on the card, its
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def stop_profiler(prof, device: torch.device, out_dir: str, mode: str, rank: int) -> Path:
    """Stop ``prof`` once the card has run what it traced, and write its
    Chrome trace ``{out_dir}/{mode}_rank{rank}.pt.trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    path = Path(out_dir) / f"{mode}_rank{rank}.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def run_test_sweep(trainer, test_ds, config, step: int, metric_logger, rng,
                   stage1: bool = False) -> dict:
    """Eval metrics over the whole test split, weighted by the true example
    count of each batch (the ragged last one included); in stage 2 each
    batch's noise is ``normal(eval_rng, (rows, vae_dim))`` after ``rng,
    eval_rng = split(rng)``, ``rng`` starting at the chain's key (the
    caller's is not advanced), as JAX's sweep draws it. Under data parallelism
    every process sweeps the whole split with no collective (the
    single-process numbers), and the metric logger of rank 0 alone writes."""
    from ..data import HostDataPipeline

    t_cfg = config.training
    pipe = HostDataPipeline(test_ds, t_cfg.batch_size, num_workers=config.data.num_workers,
                            seed=0, drop_remainder=False)
    totals: dict[str, float] = {}
    n_batches = n_examples = 0
    t0 = time.perf_counter()
    for batch in pipe.batches():
        bs = batch["image"].shape[0]
        if stage1:
            metrics = trainer.eval_step(batch)
        else:
            rng, eval_rng = jax_random.split(rng)
            metrics = trainer.eval_step(batch, jax_random.normal(eval_rng, (bs, trainer.vae_dim)))
        for name, v in metrics.items():
            totals[name] = totals.get(name, 0.0) + float(v) * bs
        n_batches += 1
        n_examples += bs
    duration = time.perf_counter() - t0
    avg = {k: v / max(n_examples, 1) for k, v in totals.items()}
    metric_logger.log_metrics("test", step, avg)
    metric_logger.log_console(step, avg.get("loss_D", float("nan")),
                              avg.get("loss_G", float("nan")), n_examples / max(duration, 1e-9),
                              duration / max(n_batches, 1), prefix="test: ")
    return avg


if __name__ == "__main__":
    main()
