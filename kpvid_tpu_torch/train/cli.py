"""Train stage 1 (the keypoint detector and translator) or stage 2 (the
motion generator).

    python -m kpvid_tpu_torch.train --mode detector_translator \
        --config kpvid_tpu/configs/penn.yaml
    python -m kpvid_tpu_torch.train --mode motion_generator \
        --config kpvid_tpu/configs/penn.yaml

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
'two_batch'), and, in stage 2, the VAE noise of step ``s``, drawn on the
host from ``np.random.default_rng([seed, s])``, is the uninterrupted run's
(stage 1 draws no noise); the CLI asks cuDNN for its deterministic
algorithms, so that a resumed stage-1 run repeats the bits too. The trainer
runs on the card and raises without one (``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

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
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser


def step_noise(seed: int, step: int, n: int, rows: int, vae_dim: int) -> np.ndarray:
    """The VAE noise of train step ``step``: [n, rows, vae_dim] f32 (n = 1
    for 'fused', 2 for the (D, G) draws of 'fused_dg' and 'two_batch')."""
    return np.random.default_rng([seed, step]).standard_normal((n, rows, vae_dim),
                                                               dtype=np.float32)


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
    data_dir = config.paths.data_dir
    stage1 = args.mode == "detector_translator"
    if args.synthetic:
        from ..data import make_synthetic_penn_tree, make_synthetic_pseudo_labels

        make_synthetic_penn_tree(data_dir)
        if not stage1:
            make_synthetic_pseudo_labels(data_dir, n_pts=m_cfg.n_pts)
    if stage1:
        from ..data import ImagePairDataset
        from ..eval.visualize import stage1_summary_images
        from .stage1 import Stage1Trainer

        train_ds, test_ds = (ImagePairDataset(data_dir, subset, image_size=m_cfg.image_size,
                                              native_ops=config.data.native_ops)
                             for subset in ("train", "test"))
        trainer = Stage1Trainer(config, vgg_params(config), device=device)
    else:
        from ..data import SequenceDataset
        from ..eval.visualize import stage2_summary_images
        from .stage2 import Stage2Trainer

        kw = dict(n_pts=m_cfg.n_pts, n_action=m_cfg.n_action,
                  sequence_len=config.data.sequence_len, image_size=m_cfg.image_size,
                  native_ops=config.data.native_ops)
        train_ds = SequenceDataset(data_dir, "train", **kw)
        test_ds = SequenceDataset(data_dir, "test", **kw)
        trainer = Stage2Trainer(config, device=device)
    trainer.load_parameters(trainer.init_parameters(t_cfg.seed))
    ckpt_dir = Path(config.paths.log_dir) / args.mode
    if t_cfg.resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            trainer.load_state_arrays(load_checkpoint(latest))
            logger.info("resumed from %s (step %d)", latest, trainer.step)

    metric_logger = MetricLogger(config.paths.log_dir, args.mode)
    ckpt_manager = AsyncCheckpointManager(config.paths.log_dir, args.mode,
                                          keep=t_cfg.keep_checkpoints)
    throughput = Throughput()
    n_steps = args.max_steps if args.max_steps is not None else t_cfg.n_steps
    two_batch = t_cfg.gan_step_mode == "two_batch"
    fused_dg = t_cfg.gan_step_mode == "fused_dg"
    bs = t_cfg.batch_size
    start_step = trainer.step
    train_pipe = HostDataPipeline(
        train_ds, bs, shuffle=True, repeat=True, num_workers=config.data.num_workers,
        prefetch=config.data.prefetch, seed=t_cfg.seed,
        start_sample=start_step * bs * (2 if two_batch else 1),
    )
    logger.info("training %s from step %d to %d on %s", args.mode, start_step, n_steps, device)
    colors = get_n_colors(m_cfg.n_pts)
    batches = train_pipe.batches()
    train_iter = device_prefetch(batches, device, size=config.data.prefetch)

    def train_step(step: int, batch: dict) -> dict:
        if stage1:
            if two_batch:
                return trainer.train_step_two_batch(batch, next(train_iter))
            return trainer.train_step_dg(batch) if fused_dg else trainer.train_step(batch)
        vae = m_cfg.vae_dim
        if two_batch or fused_dg:
            noise_d, noise_g = step_noise(t_cfg.seed, step, 2, bs, vae)
            if two_batch:
                return trainer.train_step_two_batch(batch, next(train_iter), noise_d, noise_g)
            return trainer.train_step_dg(batch, noise_d, noise_g)
        return trainer.train_step(batch, step_noise(t_cfg.seed, step, 1, bs, vae)[0])

    def summary_images(step: int, batch: dict) -> dict:
        if stage1:
            return stage1_summary_images(trainer, batch, colors)
        noise = np.random.default_rng([t_cfg.seed, step, 2]).standard_normal(
            (min(2, bs), m_cfg.vae_dim), dtype=np.float32)
        return stage2_summary_images(trainer, batch, colors, noise)

    metrics = {}
    t_start = time.perf_counter()
    try:
        for step in range(start_step, n_steps):
            t0 = time.perf_counter()
            batch = next(train_iter)
            metrics = train_step(step, batch)
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
                if not args.no_images:
                    metric_logger.log_images("train", step, summary_images(step, batch))
            if step % t_cfg.checkpoint_interval == 0 and step > start_step:
                ckpt_manager.save(step, trainer.state_arrays())
            if step % t_cfg.test_interval == 0:
                run_test_sweep(trainer, test_ds, config, step, metric_logger, stage1)
        ckpt_manager.save(n_steps, trainer.state_arrays())
        ckpt_manager.wait()
    finally:
        train_iter.close()
        batches.close()
        metric_logger.close()
    seconds = time.perf_counter() - t_start
    logger.info("done at step %d", n_steps)
    return {"trainer": trainer, "start_step": start_step, "end_step": n_steps,
            "metrics": {k: float(v) for k, v in metrics.items()}, "seconds": seconds,
            "checkpoint_dir": str(ckpt_dir)}


def run_test_sweep(trainer, test_ds, config, step: int, metric_logger,
                   stage1: bool = False) -> dict:
    """Eval metrics over the whole test split, weighted by the true example
    count of each batch (the ragged last one included); in stage 2 the noise
    of batch k is default_rng([seed, step, 1, k])'s."""
    from ..data import HostDataPipeline

    t_cfg = config.training
    pipe = HostDataPipeline(test_ds, t_cfg.batch_size, num_workers=config.data.num_workers,
                            seed=0, drop_remainder=False)
    totals: dict[str, float] = {}
    n_batches = n_examples = 0
    t0 = time.perf_counter()
    for k, batch in enumerate(pipe.batches()):
        bs = batch["image"].shape[0]
        if stage1:
            metrics = trainer.eval_step(batch)
        else:
            noise = np.random.default_rng([t_cfg.seed, step, 1, k]).standard_normal(
                (bs, trainer.vae_dim), dtype=np.float32)
            metrics = trainer.eval_step(batch, noise)
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
