"""Multi-process runs, one process per card (torch.distributed).

Counterpart of kpvid_tpu/parallel/: ``distributed`` (the KPVID_* process
contract, barriers, the local batch), ``mesh`` (the run's ('data',
'model') layout over its processes and the process groups of both axes),
``sharding`` (which arrays shard over 'model', and their shards and full
arrays), ``tensor`` (the column-parallel layers' collectives), ``dp_step``
(the trainers with their gradient, metric and BN reductions over 'data')
and ``inventory`` (the collectives of a profiled step).

Names that differ from the JAX package's: ``shard_state`` cuts full arrays
to this process's shards and ``gather_state`` joins them back (JAX's
``shard_state`` lays a whole train state out on a mesh, and its checkpoint
gathers); ``batch_shard`` is a process's (shard_id, num_shards) of the data
pipeline, where JAX has ``batch_sharding`` / ``shard_batch`` (a process
feeds its own rows here, so there is no global batch to lay out);
``replicate`` has no counterpart (one process over several cards keeps a
replica per card: eval/final.py::GeneratorMesh).
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
from .sharding import batch_shard, gather_state, param_sharding_rules, shard_dim, shard_state
from .tensor import ModelShard

__all__ = [
    "CollectiveInventory",
    "Mesh",
    "ModelShard",
    "all_reduce_mean",
    "barrier",
    "batch_shard",
    "collective_inventory",
    "gather_state",
    "is_primary",
    "local_batch_size",
    "make_dp_reduce_step",
    "make_mesh",
    "maybe_initialize",
    "param_sharding_rules",
    "select_step",
    "shard_dim",
    "shard_state",
    "world",
]
