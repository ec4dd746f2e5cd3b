"""End-to-end generation over the test split, written as a tree of PNGs.

    python -m kpvid_tpu_torch.evaluate --config kpvid_tpu_torch/configs/penn.yaml \
        --checkpoint_stage1 stage1.npz --checkpoint_stage2 results/motion_generator \
        --save_dir results/eval

Counterpart of the JAX package's ``evaluate.py``. Each checkpoint is a
``.npz`` parameter file, a trainer ``ckpt-N`` directory, or the directory
above one (its newest ``ckpt-N``); they are merged into ``FinalGenerator``
by name. Every test video's first frame and action go through ``generate``
(all four kernels) at ``data.eval_batch_size``, and the keypoints are drawn
as colorized images at full resolution (``gaussian_render`` at 128^2). Per
sample, under ``<save_dir>/<index:04d>/``, the same files as JAX's:
``input_im.png``, ``current_points.png`` and 32 PNGs each in ``real_seq/``,
``pred_seq/``, ``mask/``, ``crude/`` and ``pred_points/`` (and ``pred.gif``,
``real.gif`` with ``--gif``), encoded by a pool of threads (PIL's encoder
releases the GIL), byte for byte the files JAX's writer makes of the same
arrays.

The latents of global batch ``b`` are JAX's: ``normal(fold_in(PRNGKey(seed),
b), (B, vae_dim))`` (f32), drawn on the host (utils/jax_random.py), so one
``--seed`` gives JAX's videos. It runs on the card and raises without one
(``--device cpu`` runs the plain versions on the CPU).

Several processes (the KPVID_* environment, parallel/distributed.py), one
card each: each generates and writes the batches ``i, i + N, ...`` of the
one-process run (a 'batch'-granularity shard of the pipeline), with the
latents of those global batch indices, so the tree is the one-process
tree byte for byte; the first process writes the synthetic data while the
others wait, and all wait at the end.

Generation runs through eval/final.py::GeneratorMesh, over the one device,
or with ``--mesh`` over every visible card from one process: each batch's
rows split evenly between the cards' replicas, generate and the point
images on each, read back on each replica's stream; a batch whose rows do
not split (the ragged last one) runs whole on the first card, as JAX
replicates it. ``--mesh`` refuses several processes, as JAX's does.
"""

from __future__ import annotations

import itertools
import os
import time
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .utils import jax_random


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch evaluate: the test split as PNGs")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint_stage1", type=str, required=True)
    parser.add_argument("--checkpoint_stage2", type=str, required=True)
    parser.add_argument("--save_dir", type=str, default="results/eval")
    parser.add_argument("--synthetic", action="store_true",
                        help="write a synthetic tree and labels into data_dir first")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0,
                        help="latent seed: batch b draws normal(fold_in(PRNGKey(seed), b)), as JAX's")
    parser.add_argument("--gif", action="store_true",
                        help="also write pred.gif and real.gif per sample")
    parser.add_argument("--png-workers", type=int, default=None,
                        help="PNG encoding threads (default: min(8, 2 x cores))")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain versions")
    parser.add_argument("--mesh", action="store_true",
                        help="generate batch-parallel over every visible card from one "
                             "process (one replica per card, each batch's rows split evenly; "
                             "a ragged last batch runs on the first card)")
    return parser


def batch_z(seed: int, b: int, rows: int, vae_dim: int) -> np.ndarray:
    """The latents of global batch ``b``: [rows, vae_dim] f32, JAX's
    ``normal(fold_in(PRNGKey(seed), b), (rows, vae_dim))``."""
    return jax_random.normal(jax_random.fold_in(jax_random.PRNGKey(seed), b), (rows, vae_dim))


def make_launch(colors: np.ndarray):
    """evaluate's work on one replica's rows: generate and both point
    images, queued on the replica's card and stream (``GeneratorMesh.map``)
    with no wait on the host, so the next replica's work is queued while
    this one runs. The colors [K, 3] go to each replica's device once per
    dtype (``MeshReplica.constant``)."""

    def launch(rep, images, actions, z):
        out = rep.final.generate(images, actions, z)
        cur, fut = out["current_points"], out["future_points"]
        return dict(
            out,
            current_points_im=rep.final.render_point_images(
                cur, rep.constant("colors", colors, cur.dtype)),
            future_points_im=rep.final.render_point_images(
                fut.reshape(-1, *fut.shape[-2:]), rep.constant("colors", colors, fut.dtype)))

    return launch


def main(argv=None) -> dict:
    """Write the PNG tree; returns the run's counts and seconds."""
    args = build_parser().parse_args(argv)
    from .parallel import barrier, is_primary, maybe_initialize, world

    multiproc = maybe_initialize(args.device)
    if args.mesh and multiproc:
        # the two scaling modes are redundant: each process already keeps its
        # own card busy on its batch shard
        raise ValueError(
            "--mesh shards one batch over a global mesh; under "
            "multi-process execution use the per-host batch sharding "
            "instead (drop --mesh)"
        )
    rank, n_proc = world()
    from .configs import load_config
    from .data import HostDataPipeline, SequenceDataset
    from .device import resolve_device
    from .eval.final import FinalGenerator, GeneratorMesh, mesh_devices
    from .serve import load_generator_parameters
    from .utils import get_n_colors, logger, setup_console_logging, touch_dir

    setup_console_logging()
    device = resolve_device(args.device)
    config = load_config(args.config)
    m = config.model
    data_dir = config.paths.data_dir
    batch_size = args.batch_size or config.data.eval_batch_size
    if args.synthetic:
        from .data import make_synthetic_penn_tree, make_synthetic_pseudo_labels

        if is_primary():  # one writer on a shared filesystem
            make_synthetic_penn_tree(data_dir)
            make_synthetic_pseudo_labels(data_dir, n_pts=m.n_pts)
        barrier("kpvid_eval_synthetic")

    # the checkpoints merged into JAX's init_variables(PRNGKey(0)), as JAX's evaluate does
    params = load_generator_parameters(FinalGenerator(config, device="cpu").init_parameters(0),
                                       args.checkpoint_stage1, args.checkpoint_stage2)
    mesh = GeneratorMesh(config, params, mesh_devices(device) if args.mesh else [device])
    if args.mesh:
        logger.info("generating over a %d-device 'data' mesh", mesh.n_data)
    launch = make_launch(get_n_colors(m.n_pts))
    test_ds = SequenceDataset(data_dir, "test", n_pts=m.n_pts, n_action=m.n_action,
                              sequence_len=config.data.sequence_len, image_size=m.image_size,
                              with_image_seq=True, native_ops=config.data.native_ops)
    pipe = HostDataPipeline(test_ds, batch_size, num_workers=config.data.num_workers, seed=0,
                            drop_remainder=False, shard_id=rank, num_shards=n_proc,
                            shard_granularity="batch")

    n_workers = args.png_workers or min(8, 2 * (os.cpu_count() or 1))
    pool = ThreadPoolExecutor(max_workers=n_workers)
    pending: list = []
    write_s = 0.0  # seconds inside the writers, summed over threads

    def submit(fn, *fn_args):
        nonlocal write_s
        pending.append(pool.submit(_timed, fn, *fn_args))
        if len(pending) > 4 * n_workers:  # bound the batches held in memory
            write_s += pending.pop(0).result()

    n_written = n_batches = 0
    data_s = generate_s = 0.0  # waiting for the next batch; generate and readback
    t_start = time.perf_counter()
    batches = pipe.batches()
    try:
        for k in itertools.count():
            b = rank + k * n_proc  # the global batch index
            t0 = time.perf_counter()
            batch = next(batches, None)
            data_s += time.perf_counter() - t0
            if batch is None:
                break
            bs = batch["image"].shape[0]
            t0 = time.perf_counter()
            inputs = (batch["image"], batch["action_code"], batch_z(args.seed, b, bs, m.vae_dim))
            out = mesh.run(launch, *inputs)
            cur = out["current_points_im"]
            fut = out["future_points_im"].reshape(bs, m.n_future_frames, m.image_size,
                                                  m.image_size, 3)
            generate_s += time.perf_counter() - t0
            n_batches += 1
            for i in range(bs):
                d = touch_dir(Path(args.save_dir) / f"{b * batch_size + i:04d}")
                submit(_save_img, d / "input_im.png", out["im"][i], True)
                submit(_save_img, d / "current_points.png", cur[i], False)
                submit(_save_seq, d / "real_seq", batch["real_im_seq"][i], True)
                submit(_save_seq, d / "pred_seq", out["pred_im_seq"][i], True)
                submit(_save_seq, d / "mask", out["mask"][i], False)
                submit(_save_seq, d / "crude", out["pred_im_crude"][i], True)
                submit(_save_seq, d / "pred_points", fut[i], False)
                if args.gif:
                    submit(_save_gif, d / "pred.gif", out["pred_im_seq"][i], True)
                    submit(_save_gif, d / "real.gif", batch["real_im_seq"][i], True)
                n_written += 1
        for f in pending:  # raise any writer's error; every file is on disk after
            write_s += f.result()
    finally:
        batches.close()
        pool.shutdown(wait=True, cancel_futures=True)
    seconds = time.perf_counter() - t_start
    logger.info("wrote %d samples in %d batches to %s in %.2fs (%.2f samples/s); waiting for "
                "data %.2fs, generate %.2fs, PNG writers %.2fs over %d threads%s", n_written,
                n_batches, args.save_dir, seconds, n_written / max(seconds, 1e-9), data_s,
                generate_s, write_s, n_workers,
                f" [process {rank}/{n_proc}]" if multiproc else "")
    barrier("kpvid_eval_done")  # every shard's PNGs are on disk before anyone reads them
    return {"samples": n_written, "batches": n_batches, "seconds": seconds,
            "data_seconds": data_s, "generate_seconds": generate_s, "write_seconds": write_s,
            "png_workers": n_workers, "save_dir": str(args.save_dir)}


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def _save_gif(file_path, seq: np.ndarray, rescale: bool, fps: int = 8):
    """Animated GIF of a [T, H, W, 3] sequence."""
    from PIL import Image

    if rescale:
        seq = 0.5 * (seq + 1.0)
    frames = [Image.fromarray((np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)) for f in seq]
    frames[0].save(file_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def _save_img(file_path, img: np.ndarray, rescale: bool):
    from PIL import Image

    mode = None
    if img.shape[-1] <= 2:
        img, mode = img[..., 0], "L"
    if rescale:
        img = 0.5 * (img + 1.0)
    img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    Image.fromarray(img, mode=mode).save(file_path)


def _save_seq(out_dir, seq: np.ndarray, rescale: bool):
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    for i in range(seq.shape[0]):
        _save_img(Path(out_dir) / f"{i:06d}.png", seq[i], rescale)


if __name__ == "__main__":
    main()
