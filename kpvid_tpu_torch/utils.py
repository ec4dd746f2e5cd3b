"""The CLIs' logger and ``touch_dir`` (copies of kpvid_tpu/utils/logging.py's
console logger and kpvid_tpu/utils/misc.py::touch_dir)."""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("kpvid_tpu_torch")


def setup_console_logging() -> None:
    """One plain console line per record; for the CLIs, not for importers."""
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False


def touch_dir(target_dir: str | Path) -> Path:
    """Create a directory (and parents) if missing; return it."""
    p = Path(target_dir)
    p.mkdir(parents=True, exist_ok=True)
    return p
