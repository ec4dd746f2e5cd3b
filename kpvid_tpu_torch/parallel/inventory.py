"""Collective inventory of a profiled run: ops and payload bytes.

Counterpart of kpvid_tpu/parallel/inventory.py, which tallies the
collectives of a compiled program's HLO. The port has no program to read:
each collective of torch.distributed opens a profiler record named after its
backend and op (``nccl:all_reduce``, ``gloo:all_reduce``), with its input
tensors' shapes and dtypes when the profiler records shapes. So the tally is
of a ``torch.profiler.profile(record_shapes=True)`` around the work (one
train step): how many collectives of each op, and the bytes of their inputs.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_RECORD_RE = re.compile(r"^(?:nccl|gloo):(?P<op>[a-z_]+)$")
# the dtype names of the profiler's records
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "int": 4, "long int": 8,
    "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
}


@dataclass
class CollectiveInventory:
    """Per-op collective counts and payload bytes."""

    counts: dict = field(default_factory=dict)  # op -> int
    bytes: dict = field(default_factory=dict)   # op -> payload bytes
    dtypes: dict = field(default_factory=dict)  # op -> sorted dtype names seen

    @property
    def total_ops(self) -> int:
        return sum(self.counts.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def ops_other_than(self, *allowed: str) -> dict:
        return {k: v for k, v in self.counts.items() if k not in allowed}


def collective_inventory(prof) -> CollectiveInventory:
    """Tally the collectives that ``prof`` (a finished
    ``torch.profiler.profile(record_shapes=True)``) recorded."""
    inv = CollectiveInventory()
    for event in prof.profiler.kineto_results.events():
        m = _RECORD_RE.match(event.name())
        if not m:
            continue
        op = m.group("op")
        payload = 0
        for shape, dtype in zip(event.shapes(), event.dtypes()):
            if dtype not in _DTYPE_BYTES:
                raise ValueError(f"{event.name()}: unknown dtype {dtype!r} in the profile")
            payload += math.prod(shape) * _DTYPE_BYTES[dtype]
        inv.counts[op] = inv.counts.get(op, 0) + 1
        inv.bytes[op] = inv.bytes.get(op, 0) + payload
        inv.dtypes[op] = sorted(set(inv.dtypes.get(op, [])) | set(event.dtypes()))
    return inv
