"""The port's parameter file and the name-intersection merge.

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
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch


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
