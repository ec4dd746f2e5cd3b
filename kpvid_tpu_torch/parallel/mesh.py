"""The ('data', 'model') layout of a run's processes, and its process groups.

Counterpart of kpvid_tpu/parallel/mesh.py. The port runs one process per
card, so the mesh is laid over the processes: rank ``r`` sits at
coordinates ``(d, m) = (r // model, r % model)``, JAX's
``reshape(n_data, n_model)`` of the device list. ``data`` processes average
their gradients (the ranks of one ``m`` form its 'data' group); the
``model`` processes of one ``d`` hold the shards of the wide kernels
(tensor parallelism, parallel/sharding.py and parallel/tensor.py) and form
its 'model' group. Barriers stay on the whole run's group
(parallel/distributed.py).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from .distributed import _timeout, world
from .tensor import ModelShard


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1
    d: int = 0  # this process's coordinates
    m: int = 0
    # the process groups of this process's 'data' and 'model' axes (None:
    # the whole run's default group, or no group)
    data_group: object = dataclasses.field(default=None, compare=False)
    model_group: object = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def shard(self) -> ModelShard | None:
        """This process's place on the 'model' axis; None without one."""
        return ModelShard(self.m, self.model, self.model_group) if self.model > 1 else None


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over every process of the run; ``n_data`` defaults to all of
    them over ``n_model`` (pure DP when ``n_model`` is 1). With a 'model'
    axis it creates the process groups of both axes, which every process
    must do together (``torch.distributed.new_group``)."""
    rank, n_total = world()
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        if n_total % n_model:
            raise ValueError(f"{n_total} processes not divisible by n_model={n_model}")
        n_data = n_total // n_model
    if n_data * n_model != n_total:
        raise ValueError(
            f"mesh {n_data}x{n_model} != {n_total} processes (one card each)"
        )
    d, m = divmod(rank, n_model)
    if n_model == 1:
        return Mesh(n_data, 1, d, m)
    groups = {}
    for dd in range(n_data):  # every process creates every group, in one order
        groups["model", dd] = dist.new_group([dd * n_model + mm for mm in range(n_model)],
                                             timeout=_timeout())
    for mm in range(n_model):
        groups["data", mm] = dist.new_group([dd * n_model + mm for dd in range(n_data)],
                                            timeout=_timeout())
    return Mesh(n_data, n_model, d, m, data_group=groups["data", m],
                model_group=groups["model", d])
