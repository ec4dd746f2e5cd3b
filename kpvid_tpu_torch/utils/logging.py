"""The CLIs' console logger and the trainer's metric logger.

Copies of kpvid_tpu/utils/logging.py: one JSONL file of scalar metrics per
split (``{log_dir}/{name}/{split}_metrics.jsonl``), image summaries as PNGs
under ``{log_dir}/{name}/{split}_images/``, and the console line
``step N, loss_D = x, loss_G = y (E examples/sec) S sec/batch``. With
``tensorboard=True`` the scalars and the images also go to TensorBoard
event files, one ``torch.utils.tensorboard.SummaryWriter`` per split under
``{log_dir}/{name}/{split}/``; the writer's module is imported when the
logger is made, so a run that asks for it and cannot import it fails at
the start.
"""

from __future__ import annotations

import json
import logging
import time
from datetime import datetime
from pathlib import Path

import numpy as np

logger = logging.getLogger("kpvid_tpu_torch")


def setup_console_logging() -> None:
    """One plain console line per record; for the CLIs, not for importers."""
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False


def _to_scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class MetricLogger:
    def __init__(self, log_dir: str | Path, name: str, tensorboard: bool = False,
                 enabled: bool = True):
        """enabled=False makes every method a no-op: the processes of a
        data-parallel run other than the first write no logs (and open no
        TensorBoard writer)."""
        self.enabled = enabled
        self.root = Path(log_dir) / name
        if enabled:
            self.root.mkdir(parents=True, exist_ok=True)
        self._files = {}
        self._tb = {}
        self._summary_writer = None
        if tensorboard and enabled:
            from torch.utils.tensorboard import SummaryWriter  # heavy: only when asked

            self._summary_writer = SummaryWriter

    def _jsonl(self, split: str):
        if split not in self._files:
            self._files[split] = open(self.root / f"{split}_metrics.jsonl", "a")
        return self._files[split]

    def _tb_writer(self, split: str):
        if self._summary_writer is None:
            return None
        if split not in self._tb:
            self._tb[split] = self._summary_writer(str(self.root / split))
        return self._tb[split]

    def log_metrics(self, split: str, step: int, metrics: dict) -> None:
        if not self.enabled:
            return
        scalars = {k: _to_scalar(v) for k, v in metrics.items()}
        scalars = {k: v for k, v in scalars.items() if v is not None}
        f = self._jsonl(split)
        f.write(json.dumps({"step": int(step), "time": time.time(), **scalars}) + "\n")
        f.flush()
        tb = self._tb_writer(split)
        if tb is not None:
            for k, v in scalars.items():
                tb.add_scalar(k, v, int(step))

    def log_console(self, step: int, loss_d: float, loss_g: float, examples_per_sec: float,
                    sec_per_batch: float, prefix: str = "") -> None:
        if not self.enabled:
            return
        logger.info(
            "%s%s: step %d, loss_D = %.4f, loss_G = %.4f (%.1f examples/sec) %.3f sec/batch",
            prefix, datetime.now(), step, loss_d, loss_g, examples_per_sec, sec_per_batch,
        )

    def log_images(self, split: str, step: int, images: dict[str, np.ndarray],
                   max_outputs: int = 2) -> None:
        """images: name -> [B, H, W, C] float arrays in [-1, 1], [0, 1] or
        [0, 255], saved as PNGs, and as TensorBoard images when it is on."""
        if not self.enabled:
            return
        from PIL import Image

        out_dir = self.root / f"{split}_images"
        out_dir.mkdir(exist_ok=True)
        tb = self._tb_writer(split)
        for name, arr in images.items():
            arr = np.asarray(arr)[:max_outputs]
            for b in range(arr.shape[0]):
                img = arr[b]
                if img.min() < -0.01:  # [-1, 1] -> [0, 1]
                    img = (img + 1.0) / 2.0
                if img.max() <= 1.001:
                    img = img * 255.0
                img = np.clip(img, 0, 255).astype(np.uint8)
                if img.shape[-1] == 1:
                    img = img[..., 0]
                Image.fromarray(img).save(out_dir / f"{name}_{step:08d}_{b}.png")
                if tb is not None:
                    hwc = img if img.ndim == 3 else img[..., None]
                    tb.add_image(f"{name}/{b}", hwc, int(step), dataformats="HWC")

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files = {}
        for tb in self._tb.values():
            tb.close()
        self._tb = {}


class Throughput:
    """examples/s and s/batch since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._examples = 0
        self._batches = 0

    def update(self, batch_size: int):
        self._examples += batch_size
        self._batches += 1

    def rates(self) -> tuple[float, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._examples / dt, dt / max(self._batches, 1)
