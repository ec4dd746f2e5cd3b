"""Host utilities of the CLIs: the console logger, the training metric
logger, the keypoint palette and ``touch_dir`` (copies of
kpvid_tpu/utils/{logging,colors,misc}.py)."""

from __future__ import annotations

from pathlib import Path

from .colors import get_n_colors
from .logging import MetricLogger, Throughput, logger, setup_console_logging


def touch_dir(target_dir: str | Path) -> Path:
    """Create a directory (and parents) if missing; return it."""
    p = Path(target_dir)
    p.mkdir(parents=True, exist_ok=True)
    return p


__all__ = ["MetricLogger", "Throughput", "get_n_colors", "logger", "setup_console_logging",
           "touch_dir"]
