"""The serving artifact: the generation graph, weights baked in, in one file.

Counterpart of kpvid_tpu/eval/export.py. :func:`export_serving` traces
:class:`~kpvid_tpu_torch.eval.final.GenerateNet` (the tensor form of
``FinalGenerator.generate``) with ``torch.export`` once per batch size, with
the model's parameters and BN statistics carried in each program, and writes
ONE ``.npz``. :func:`load_serving` needs neither the model code
(``models/``), a config nor a checkpoint: it imports ``kpvid_tpu_torch.ops``,
whose ``torch.ops.kpvid`` registrations (ops/library.py) the programs call,
and deserializes. The kernels are nodes of the graph, so the artifact runs
the same hand-written kernels as the live engine on the card, and their
plain versions on the CPU.

Contract: a video is a pure function of (image, action one-hot, z), the
serving daemon's batching-invariant signature, so each program takes z
explicitly and holds no random state. Shapes are static, one program per
batch bucket, as the daemon's buckets are.

Artifact format, a single .npz:
    meta         uint8 blob of a JSON dict: format_version, image_size,
                 n_action, vae_dim, n_future_frames, batch_sizes, outputs,
                 torch_version, device (where the programs were traced)
    graph_b{B}   uint8 blob: torch.export.save of the ExportedProgram at batch B

Programs are traced under ``torch.no_grad()`` with the model in ``eval()``,
so BN is in its inference form and no running statistic is updated.
:func:`load_serving` moves each program to the device it is asked for with
``torch.export.passes.move_to_device_pass``: a program traced on a CPU runs
on the card, through the kernels, and the other way round. An artifact is
read by the torch version that wrote it (``meta["torch_version"]``).

Size: every program carries all the weights in f32, so the file grows by the
weights once per bucket. At ``Config()`` they are 77.4 MB (stage2.dec_lstm
50.9 MB, the translator 12.4 MB, the pose encoder 9.0 MB, the image encoder
4.7 MB); with its graph and ``torch.export.save``'s copy of the example
inputs a program is 80.8 MB at bucket 1 and 87.0 MB at bucket 32, so the
default (1, 32) artifact is about 168 MB and all six daemon buckets about
496 MB.
"""

from __future__ import annotations

import copy
import io
import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device, to_device

_FORMAT_VERSION = 1


def export_serving(final, path: str | Path, batch_sizes: Sequence[int] = (1, 32),
                   device: str | torch.device | None = None) -> dict:
    """Trace ``final``'s generation (a ``FinalGenerator`` with its parameters
    loaded) once per batch size on ``device`` (default: ``final.device``)
    and write the artifact to ``path``. Returns the artifact's meta dict."""
    m = final.config.model
    batch_sizes = sorted({int(b) for b in batch_sizes})
    if not batch_sizes or min(batch_sizes) < 1:
        raise ValueError(f"batch_sizes must be positive ints, got {batch_sizes}")
    dev = final.device if device is None else resolve_device(device)
    net = final.model if dev == final.device else copy.deepcopy(final.model).to(dev)
    net.eval()

    arrays: dict[str, np.ndarray] = {}
    outputs: list[str] = []
    for b in batch_sizes:
        example = (
            torch.zeros((b, m.image_size, m.image_size, 3), dtype=torch.float32, device=dev),
            torch.zeros((b, m.n_action), dtype=torch.float32, device=dev),
            torch.zeros((b, m.vae_dim), dtype=torch.float32, device=dev),
        )
        with torch.no_grad():
            program = torch.export.export(net, example)
        outputs = sorted(program.call_spec.out_spec.context)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        arrays[f"graph_b{b}"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)

    meta = {
        "format_version": _FORMAT_VERSION,
        "image_size": m.image_size,
        "n_action": m.n_action,
        "vae_dim": m.vae_dim,
        "n_future_frames": m.n_future_frames,
        "batch_sizes": batch_sizes,
        "outputs": outputs,
        "torch_version": torch.__version__,
        "device": dev.type,
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return meta


class ServingArtifact:
    """A loaded serving artifact: call ``generate(im, action_code, z)``.

    ``programs`` holds each bucket's ExportedProgram on :attr:`device`; each
    is turned into one callable module at load time."""

    def __init__(self, meta: dict, programs: dict, device: torch.device):
        self.meta = meta
        self.device = device
        self.batch_sizes = sorted(programs)
        self.programs = programs
        self._modules = {b: p.module() for b, p in programs.items()}

    def generate(self, im, action_code, z) -> dict:
        """im [B, S, S, 3] in [-1, 1], action_code [B, A] one-hot, z
        [B, vae_dim] (numpy or tensors); B must be one of the exported
        buckets. Returns the outputs named in ``meta["outputs"]`` on
        :attr:`device`."""
        b = im.shape[0]
        if b not in self._modules:
            raise ValueError(f"batch size {b} not in exported buckets {self.batch_sizes}")
        with torch.no_grad():
            return self._modules[b](
                to_device(im, self.device, torch.float32),
                to_device(action_code, self.device, torch.float32),
                to_device(z, self.device, torch.float32),
            )


def load_serving(path: str | Path, device: str | torch.device = "cuda") -> ServingArtifact:
    """Load an artifact written by :func:`export_serving` onto ``device``
    (the card by default; ``"cpu"`` runs the plain versions). Imports the
    ops' registrations, and no model code."""
    from .. import ops  # noqa: F401 - registers torch.ops.kpvid before deserializing
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode("utf-8"))
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported artifact format {meta.get('format_version')!r}")
        programs = {
            b: move_to_device_pass(
                torch.export.load(io.BytesIO(data[f"graph_b{b}"].tobytes())), str(dev))
            for b in meta["batch_sizes"]
        }
    return ServingArtifact(meta, programs, dev)
