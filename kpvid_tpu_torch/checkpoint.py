"""The port's parameter files, the trainer's checkpoints, and the
name-intersection merge.

Counterpart of kpvid_tpu/utils/checkpoint.py's ``merge_restore``. The JAX
package keeps its weights in Orbax directories, which the port cannot read
without JAX; the port keeps them in one ``.npz`` of float32 arrays keyed by
its own parameter names (``stage1.pose_encoder.dec0a.conv.weight``, ...),
read with ``allow_pickle=False``. ``tools/export_torch_params.py`` writes
such a file from a JAX ``ckpt-N`` directory.

``merge_parameters`` grafts every source tensor whose name is in the target
and leaves the rest of the target as it is: a stage-1 and a stage-2 file
compose into one set of parameters, as the JAX CLIs compose their two
checkpoints.

A trainer checkpoint (counterpart of kpvid_tpu/utils/checkpoint.py's
``AsyncCheckpointManager``) is a directory ``{log_dir}/{name}/ckpt-{step}/``
holding one ``state.npz``: the step, both parameter sets and both Adam
states, each array in its own dtype. The file is written under a temporary
name and renamed, from a background thread, and ``keep`` keeps the newest
checkpoints only. The generator's arrays carry ``FinalGenerator``'s
``stage2.`` prefix, so a trainer checkpoint is also a parameter file:
:func:`resolve_parameter_file` lets the CLIs take a ``.npz``, a ``ckpt-N``
directory, or the directory above them (its newest ``ckpt-N``).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

STATE_FILE = "state.npz"
_STEP_RE = re.compile(r"ckpt-(\d+)$")


def save_parameters(path: str | Path, params: Mapping) -> Path:
    """Write ``params`` (name -> tensor or array) as an uncompressed .npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        name: (val.detach().cpu().float().numpy() if torch.is_tensor(val)
               else np.asarray(val, np.float32))
        for name, val in params.items()
    }
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_parameters(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a file of :func:`save_parameters` as name -> CPU f32 tensor."""
    with np.load(Path(path), allow_pickle=False) as data:
        return {name: torch.from_numpy(np.array(data[name], np.float32)) for name in data.files}


def merge_parameters(target: Mapping, source: Mapping) -> tuple[dict, int]:
    """Take every tensor of ``source`` whose name is in ``target``; returns
    (merged, number of names matched). Raises if no name matches, or if a
    matched tensor has another shape than the target's."""
    merged = dict(target)
    n = 0
    for name, val in source.items():
        if name not in merged:
            continue
        val = torch.as_tensor(val)
        if tuple(val.shape) != tuple(merged[name].shape):
            raise ValueError(f"shape mismatch at {name}: file {tuple(val.shape)} vs "
                             f"target {tuple(merged[name].shape)}")
        merged[name] = val.to(merged[name].dtype)
        n += 1
    if n == 0:
        raise ValueError("the parameter file matched 0 tensors of the model")
    return merged, n


def list_checkpoint_steps(ckpt_dir: str | Path) -> list[int]:
    """The steps of the complete checkpoints (``ckpt-N/state.npz``) under
    ``ckpt_dir``, ascending."""
    root = Path(ckpt_dir)
    if not root.is_dir():
        return []
    steps = []
    for p in root.iterdir():
        m = _STEP_RE.search(p.name)
        if m and (p / STATE_FILE).is_file():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    steps = list_checkpoint_steps(ckpt_dir)
    return Path(ckpt_dir) / f"ckpt-{steps[-1]}" if steps else None


def resolve_parameter_file(path: str | Path, flag: str = "checkpoint") -> Path:
    """A CLI's checkpoint argument as a .npz file: the file itself, the
    ``state.npz`` of a ``ckpt-N`` directory, or that of the newest ``ckpt-N``
    under a directory."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"{flag}: checkpoint not found at {p}")
    if p.is_file():
        return p
    if not _STEP_RE.search(p.name):
        latest = latest_checkpoint(p)
        if latest is None:
            raise FileNotFoundError(f"{flag}: no ckpt-N directories under {p}")
        p = latest
    if not (p / STATE_FILE).is_file():
        raise FileNotFoundError(f"{flag}: {p} holds no {STATE_FILE}")
    return p / STATE_FILE


def save_checkpoint(log_dir: str | Path, name: str, step: int, arrays: Mapping,
                    keep: int | None = None) -> Path:
    """Write ``arrays`` (name -> tensor or array, any device) to
    ``{log_dir}/{name}/ckpt-{step}/state.npz``; ``keep`` removes all but the
    newest ``keep`` checkpoints."""
    root = Path(log_dir).resolve() / name
    path = root / f"ckpt-{step}"
    path.mkdir(parents=True, exist_ok=True)
    host = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in arrays.items()}
    tmp = path / f".{STATE_FILE}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, path / STATE_FILE)
    if keep is not None:
        for old in list_checkpoint_steps(root)[:-keep]:
            shutil.rmtree(root / f"ckpt-{old}", ignore_errors=True)
    return path


def load_checkpoint(path: str | Path) -> dict[str, np.ndarray]:
    """The arrays of a ``ckpt-N`` directory (or its ``state.npz``), each in
    its saved dtype."""
    p = Path(path)
    with np.load(p / STATE_FILE if p.is_dir() else p, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


class AsyncCheckpointManager:
    """Saves that do not hold up the train loop: ``save`` copies the arrays
    on their device (in stream order, before any later update) and a
    background thread copies them to the host and writes the file. One save
    is in flight at a time; ``wait`` joins it and raises its error."""

    def __init__(self, log_dir: str | Path, name: str, keep: int | None = None):
        self.log_dir = log_dir
        self.name = name
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, arrays: Mapping) -> None:
        self.wait()
        snapshot = {k: v.detach().clone() for k, v in arrays.items()}

        def run():
            try:
                save_checkpoint(self.log_dir, self.name, step, snapshot, keep=self.keep)
            except Exception as e:  # noqa: BLE001 - raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
