"""Device selection, and host <-> card copies that do not stall the host.

- :func:`resolve_device`: the entry points run on the card by default and
  raise without one.
- :func:`to_device`: a host array bound for the card is staged in pinned
  memory and copied with ``non_blocking=True`` on the current stream, so the
  host goes on launching while the copy runs.
- :func:`start_readback`: device results are copied to pinned host buffers
  on a second stream, ordered after the work the current stream has queued
  so far; the returned :class:`Readback` waits for that copy alone, not for
  the whole device. ``record_stream`` keeps the caching allocator from
  handing a result's memory to later work while the copy still reads it.
  The pinned buffers come from PyTorch's caching host allocator, which does
  not reuse a block until the copies that used it are done.
  Given ``host`` buffers, the copy lands there (a mesh's replicas each
  into their rows of one batch's buffers: :class:`JoinedReadback`, with no
  join on the host).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device to run on, with its index for a card ('cuda' is the
    current card). A CUDA device is required to exist: an entry point asked
    for the card does not carry on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (cast on the host
    first when ``dtype`` is given)."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class Readback:
    """Host copies of device results, possibly still in flight."""

    host: dict[str, torch.Tensor]
    done: torch.cuda.Event | None  # None: the results were on the host already

    def wait(self) -> dict[str, np.ndarray]:
        """Wait for this readback's copies, then the results as numpy arrays
        (views of the host buffers)."""
        if self.done is not None:
            self.done.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


@dataclasses.dataclass
class JoinedReadback:
    """A batch read back in row blocks (one per replica of a mesh), each
    block copied into its rows of ``host``."""

    host: dict[str, torch.Tensor]
    parts: list[Readback]

    def wait(self) -> dict[str, np.ndarray]:
        for p in self.parts:
            p.wait()
        return {k: v.numpy() for k, v in self.host.items()}


def start_readback(tensors: dict[str, torch.Tensor], copy_stream: torch.cuda.Stream | None,
                   host: dict[str, torch.Tensor] | None = None) -> Readback:
    """Start copying ``tensors`` to the host on ``copy_stream`` and return
    without waiting; into ``host``'s tensors when given (pinned for a card's
    copy), else into new pinned buffers. Tensors on the CPU are returned as
    they are, or copied into ``host``."""
    if next(iter(tensors.values())).device.type != "cuda":
        if host is None:
            return Readback({k: v.detach() for k, v in tensors.items()}, None)
        for key, val in tensors.items():
            host[key].copy_(val)
        return Readback(host, None)
    queued = torch.cuda.Event()
    queued.record()
    copy_stream.wait_event(queued)
    out = {}
    with torch.cuda.stream(copy_stream):
        for key, val in tensors.items():
            buf = (host[key] if host is not None
                   else torch.empty(val.shape, dtype=val.dtype, pin_memory=True))
            buf.copy_(val, non_blocking=True)
            val.record_stream(copy_stream)
            out[key] = buf
        done = torch.cuda.Event(blocking=True)
        done.record(copy_stream)
    return Readback(out, done)
