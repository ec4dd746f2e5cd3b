"""Multi-process data parallelism, one process per card (torch.distributed).

Counterpart of kpvid_tpu/parallel/ without its tensor parallelism:
``distributed`` (the KPVID_* process contract, barriers, the local batch),
``mesh`` (the run's layout, a 'model' axis refused), ``dp_step`` (the
trainers with their gradient, metric and BN reductions) and ``inventory``
(the collectives of a profiled step).
"""

from .distributed import (
    all_reduce_mean,
    barrier,
    is_primary,
    local_batch_size,
    maybe_initialize,
    world,
)
from .dp_step import make_dp_reduce_step, select_step
from .inventory import CollectiveInventory, collective_inventory
from .mesh import Mesh, make_mesh

__all__ = [
    "CollectiveInventory",
    "Mesh",
    "all_reduce_mean",
    "barrier",
    "collective_inventory",
    "is_primary",
    "local_batch_size",
    "make_dp_reduce_step",
    "make_mesh",
    "maybe_initialize",
    "select_step",
    "world",
]
