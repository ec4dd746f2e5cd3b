"""Train stage 2 (the motion generator) on the labeler's pseudo-labels.

    python -m kpvid_tpu_torch.train --mode motion_generator \
        --config kpvid_tpu/configs/penn.yaml

(``main`` here; ``train/__main__.py`` runs it.) Counterpart of the JAX package's ``train.py`` for ``--mode
motion_generator``; ``--mode detector_translator`` (stage 1) is not ported
yet. It reads ``<data_dir>/pseudo_labels/*.npy`` (``python -m
kpvid_tpu_torch.make_pseudo_labels`` writes them; ``--synthetic`` writes a
synthetic tree and random-walk labels instead), batches the train split
through ``HostDataPipeline`` (seeded, augmented, copied to the card ahead of
the step) and runs ``Stage2Trainer``'s step of ``training.gan_step_mode``.

Each ``log_interval`` it logs the console line, each ``summary_interval``
the train metrics (``{log_dir}/motion_generator/train_metrics.jsonl``) and
the summary images, each ``test_interval`` a sweep of the test split
(``test_metrics.jsonl``), and each ``checkpoint_interval`` (and at the end)
a checkpoint ``{log_dir}/motion_generator/ckpt-{step}/`` written in the
background. ``ckpt-{step}`` holds the state after the update of loop step
``step``, as JAX's does. With ``training.resume`` a run continues from the
newest checkpoint: the data stream from sample ``step * batch_size`` (twice
that in 'two_batch'), and the VAE noise of step ``s``, drawn on the host from
``np.random.default_rng([seed, s])``, is the uninterrupted run's. The
trainer runs on the card and raises without one (``--device cpu`` runs on
the CPU).
"""

from __future__ import annotations

import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

MODES = ("detector_translator", "motion_generator")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch trainer")
    parser.add_argument("--mode", type=str, required=True, choices=MODES)
    parser.add_argument("--config", type=str, required=True, help="YAML config path")
    parser.add_argument("--synthetic", action="store_true",
                        help="write a synthetic tree and labels into data_dir first")
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


def main(argv=None) -> dict:
    """Train; returns the trainer and the run's steps, last metrics and seconds."""
    args = build_parser().parse_args(argv)
    if args.mode == "detector_translator":
        raise NotImplementedError("--mode detector_translator: stage-1 training is not ported "
                                  "yet (ROADMAP section 1, item 6)")
    from ..checkpoint import AsyncCheckpointManager, latest_checkpoint, load_checkpoint
    from ..configs import load_config
    from ..data import HostDataPipeline, SequenceDataset, device_prefetch
    from ..device import resolve_device
    from ..eval.visualize import stage2_summary_images
    from ..utils import MetricLogger, Throughput, get_n_colors, logger, setup_console_logging
    from .stage2 import Stage2Trainer

    setup_console_logging()
    device = resolve_device(args.device)
    config = load_config(args.config)
    t_cfg, m_cfg = config.training, config.model
    data_dir = config.paths.data_dir
    if args.synthetic:
        from ..data import make_synthetic_penn_tree, make_synthetic_pseudo_labels

        make_synthetic_penn_tree(data_dir)
        make_synthetic_pseudo_labels(data_dir, n_pts=m_cfg.n_pts)
    kw = dict(n_pts=m_cfg.n_pts, n_action=m_cfg.n_action, sequence_len=config.data.sequence_len,
              image_size=m_cfg.image_size, native_ops=config.data.native_ops)
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
    bs, vae = t_cfg.batch_size, m_cfg.vae_dim
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
    metrics = {}
    t_start = time.perf_counter()
    try:
        for step in range(start_step, n_steps):
            t0 = time.perf_counter()
            batch = next(train_iter)
            if two_batch or fused_dg:
                noise_d, noise_g = step_noise(t_cfg.seed, step, 2, bs, vae)
                if two_batch:
                    metrics = trainer.train_step_two_batch(batch, next(train_iter), noise_d,
                                                           noise_g)
                else:
                    metrics = trainer.train_step_dg(batch, noise_d, noise_g)
            else:
                metrics = trainer.train_step(batch, step_noise(t_cfg.seed, step, 1, bs, vae)[0])
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
                    noise = np.random.default_rng([t_cfg.seed, step, 2]).standard_normal(
                        (min(2, bs), vae), dtype=np.float32)
                    metric_logger.log_images("train", step, stage2_summary_images(
                        trainer, batch, colors, noise))
            if step % t_cfg.checkpoint_interval == 0 and step > start_step:
                ckpt_manager.save(step, trainer.state_arrays())
            if step % t_cfg.test_interval == 0:
                run_test_sweep(trainer, test_ds, config, step, metric_logger)
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


def run_test_sweep(trainer, test_ds, config, step: int, metric_logger) -> dict:
    """Eval metrics over the whole test split, weighted by the true example
    count of each batch (the ragged last one included); the noise of batch
    k is default_rng([seed, step, 1, k])'s."""
    from ..data import HostDataPipeline

    t_cfg = config.training
    pipe = HostDataPipeline(test_ds, t_cfg.batch_size, num_workers=config.data.num_workers,
                            seed=0, drop_remainder=False)
    totals: dict[str, float] = {}
    n_batches = n_examples = 0
    t0 = time.perf_counter()
    for k, batch in enumerate(pipe.batches()):
        bs = batch["image"].shape[0]
        noise = np.random.default_rng([t_cfg.seed, step, 1, k]).standard_normal(
            (bs, trainer.vae_dim), dtype=np.float32)
        for name, v in trainer.eval_step(batch, noise).items():
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
