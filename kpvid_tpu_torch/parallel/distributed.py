"""Multi-process runs: one process per card, through torch.distributed.

Counterpart of kpvid_tpu/parallel/distributed.py, with the same contract:

- every process calls :func:`maybe_initialize` before it touches a card. It
  is a no-op unless the environment asks for several processes:
    KPVID_COORDINATOR=host:port  KPVID_NUM_PROCESSES=N  KPVID_PROCESS_ID=i
      explicit wiring: ``init_process_group(init_method="tcp://host:port")``
      (how the CPU tests spawn their ranks), or
    KPVID_MULTIHOST=auto
      ``env://``: torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK;
- the backend is NCCL for a CUDA device and gloo for the CPU;
  ``KPVID_DIST_BACKEND=gloo`` lets several ranks share one card, which NCCL
  refuses. A rank's card is ``cuda:{LOCAL_RANK or process id} % device_count``;
- each process feeds its own rows: the data pipeline takes a strided shard
  of every epoch (data/base.py, ``shard_id``/``num_shards``: the process's
  data coordinate of the mesh, parallel/mesh.py) and
  :func:`local_batch_size` rows a step. There is no ``put_batch``: no global
  array is assembled, and no compile's skew can trip a rendezvous, so
  ``synced_compile`` has no counterpart either;
- every collective and every :func:`barrier` has a timeout
  (``KPVID_COLLECTIVE_TIMEOUT`` seconds, default 900): a rank that dies fails
  the others' next collective instead of hanging them. Barriers run on a
  gloo group (``monitored_barrier`` names the rank that did not arrive),
  beside the NCCL group the gradients use.

With local batch 1 the strided shards keep the single-process order: rank
``r`` holds row ``r`` of every global batch (tests/test_torch_parallel.py
relies on it). At larger local batches the global batch is a fixed
permutation of the single-process one: batch means and BN statistics do not
see it, and stage 2's noise, drawn for the global batch and sliced by rank,
pairs with other samples.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the gloo group of the barriers when the gradients run on NCCL (None: the
# default group is gloo already); set once per process by maybe_initialize,
# as torch.distributed's own group is
_BARRIER_GROUP = None


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get("KPVID_COLLECTIVE_TIMEOUT", "900")))


def _local_card(process_id: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id)) % torch.cuda.device_count()


def maybe_initialize(device: str | torch.device = "cuda") -> bool:
    """Join the process group the environment asks for, on the card of this
    rank (``device`` 'cuda') or on the CPU ('cpu').

    Returns True when running several processes (whether joined by this call
    or before). Safe to call more than once: with a group already in place
    it only reports. A CUDA device is required to exist, as everywhere in
    the port."""
    global _BARRIER_GROUP
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("KPVID_COORDINATOR")
    auto = os.environ.get("KPVID_MULTIHOST", "").lower() in ("1", "auto", "true")
    if not coord and not auto:
        return False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions on the CPU"
        )
    if coord:
        kw = dict(init_method=f"tcp://{coord}",
                  world_size=int(os.environ["KPVID_NUM_PROCESSES"]),
                  rank=int(os.environ["KPVID_PROCESS_ID"]))
    else:
        kw = dict(init_method="env://")
    backend = os.environ.get("KPVID_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device(_local_card(kw.get("rank", int(os.environ.get("RANK", "0")))))
    dist.init_process_group(backend, timeout=_timeout(), **kw)
    if backend != "gloo":
        _BARRIER_GROUP = dist.new_group(backend="gloo", timeout=_timeout())
    return dist.get_world_size() > 1


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that writes logs, checkpoints and shared data."""
    return world()[0] == 0


def local_batch_size(global_batch_size: int, n_data: int | None = None) -> int:
    """This process's share of a global batch over ``n_data`` data
    coordinates (default: every process, pure DP; the global size when
    single-process). Raises if the global batch does not split evenly."""
    n = world()[1] if n_data is None else n_data
    if global_batch_size % n:
        what = "the process count" if n_data is None else "the 'data' mesh axis"
        raise ValueError(
            f"global batch_size {global_batch_size} must be divisible by {what} ({n})"
        )
    return global_batch_size // n


def barrier(name: str) -> None:
    """Wait for every process, or fail after the collective timeout naming
    the barrier and the ranks that did not arrive. No-op when
    single-process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    try:
        dist.monitored_barrier(group=_BARRIER_GROUP, timeout=_timeout(),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


class _AllReduceMean(torch.autograd.Function):
    """pmean: the sum over a group's ranks divided by its size; its backward
    is the same mean of the cotangents (the transpose of ``lax.pmean``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (default: every rank),
    differentiable (sync-BN's statistics, over the 'data' axis)."""
    return _AllReduceMean.apply(x, group)
