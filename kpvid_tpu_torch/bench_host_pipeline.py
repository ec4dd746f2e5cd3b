"""Stage 1's host input pipeline: samples/s across worker counts, with the
frame cache and without.

    python -m kpvid_tpu_torch.bench_host_pipeline [--root DIR] [--batch 16] \
        [--batches 12] [--native auto|on|off]

Counterpart of the JAX package's ``tools/bench_host_pipeline.py``. It builds
the same Penn-sized synthetic tree (16 videos of 60 JPEG frames at 480x270
and 270x480, quality 85, the reference dataset's scale; the same bytes), then
runs ``ImagePairDataset`` through ``HostDataPipeline`` at 128^2 for each
cache budget (0 and 1,024 MB) and worker count (1, 2, 4 and the pipeline's
default) and prints examples/s; with the cache, primed to full residency
first (the rate a budget at least the decoded tree's size converges to),
its resident MB and hit rate. It runs on the host only. The JAX tool's
"device demand" (a TPU's stage-1 rate) is not printed: the card's own
stage-1 rates come from ``python -m kpvid_tpu_torch.bench_train``.
"""

from __future__ import annotations

import os
import tempfile
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

CACHE_MB = (0, 1024)
WORKERS = (1, 2, 4, None)  # None: HostDataPipeline's default


def build_tree(root: Path, n_videos: int = 16, frames: int = 60) -> None:
    """A Penn-sized tree of synthetic figures under ``root`` (kept for the
    next run: a ``.penn_sized`` marker)."""
    from .data.synthetic import _draw_figure

    if (root / ".penn_sized").exists():
        return
    rng = np.random.default_rng(0)
    (root / "frames").mkdir(parents=True, exist_ok=True)
    lines = []
    for vid in range(1, n_videos + 1):
        action = int(rng.integers(0, 9))
        w, h = (480, 270) if vid % 2 else (270, 480)
        vdir = root / "frames" / f"{vid:04d}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f in range(frames):
            im = Image.new("RGB", (w, h), (30, 40, 55))
            _draw_figure(ImageDraw.Draw(im), w, h, f / 8.0, action, vid)
            im.save(vdir / f"{f + 1:06d}.jpg", quality=85)
        lines.append(f"frames/{vid:04d} {action}")
    (root / "train_set.txt").write_text("\n".join(lines) + "\n")
    (root / ".penn_sized").write_text("ok")


def measure(ds, batch_size: int, num_workers, n_batches: int) -> float:
    """Examples/s of ``n_batches`` batches after one warm-up batch."""
    from .data import HostDataPipeline

    pipe = HostDataPipeline(ds, batch_size, shuffle=True, repeat=True, num_workers=num_workers,
                            seed=0)
    it = pipe.batches()
    try:
        next(it)  # the threads start (and, with the cache, a first pass primes it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return batch_size * n_batches / (time.perf_counter() - t0)
    finally:
        it.close()


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="stage 1's host input pipeline, samples/s")
    parser.add_argument("--root", default=str(Path(tempfile.gettempdir()) / "kpvid_hostbench"),
                        help="the synthetic tree's directory (built there once)")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--batches", type=int, default=12)
    parser.add_argument("--native", default="auto", choices=["auto", "on", "off"],
                        help="C++ geometry backend (DataConfig.native_ops)")
    return parser


def main(argv=None) -> list[dict]:
    """Print one line per (cache, workers); returns the rows."""
    args = build_parser().parse_args(argv)
    from .data import ImagePairDataset

    root = Path(args.root)
    build_tree(root)
    print(f"host: {os.cpu_count()} cpu core(s); batch {args.batch}; native={args.native}",
          flush=True)
    rows = []
    for cache_mb in CACHE_MB:
        for nw in WORKERS:
            ds = ImagePairDataset(str(root), "train", 128, decode_cache_mb=cache_mb,
                                  native_ops=args.native)
            if ds.cache is not None:  # full residency: the all-hit rate
                for rel, _ in ds.videos:
                    for t in range(ds._n_frames(rel)):
                        ds._load(rel, t)
                hits0, miss0 = ds.cache.hits, ds.cache.misses
            sps = measure(ds, args.batch, nw, args.batches)
            row = {"cache_mb": cache_mb, "workers": "auto" if nw is None else nw,
                   "examples_per_s": sps}
            extra = ""
            if ds.cache is not None:
                s = ds.cache.stats()
                dh, dm = s["hits"] - hits0, s["misses"] - miss0
                row.update(resident_mb=s["bytes"] / 2**20, hit_rate=dh / max(dh + dm, 1))
                extra = (f"  (cache {row['resident_mb']:.0f} MB resident, "
                         f"hit rate {row['hit_rate']:.0%})")
            print(f"cache={cache_mb:>5} MB workers={row['workers']:>4}: {sps:7.1f} "
                  f"examples/s{extra}", flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
