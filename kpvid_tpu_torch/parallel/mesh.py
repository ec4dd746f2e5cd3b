"""The ('data', 'model') layout of a run, checked against its processes.

Counterpart of kpvid_tpu/parallel/mesh.py. The port runs one process per
card, so the mesh is a shape and nothing else: ``data`` is the number of
processes whose gradients are averaged. A ``model`` axis (tensor
parallelism: kpvid_tpu/parallel/sharding.py's rules) is not ported, and
:func:`make_mesh` refuses one.
"""

from __future__ import annotations

import dataclasses

from .distributed import world


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over every process of the run; ``n_data`` defaults to all of
    them (pure DP)."""
    if n_model != 1:
        raise ValueError(
            f"a 'model' mesh axis of {n_model}: tensor parallelism is not ported "
            "yet (ROADMAP section 1, 'Multi-GPU, the rest'); set parallel.mesh_model "
            "(--mesh-model) to 1"
        )
    n_total = world()[1]
    if n_data is None:
        n_data = n_total
    if n_data * n_model != n_total:
        raise ValueError(
            f"mesh {n_data}x{n_model} != {n_total} processes (one card each)"
        )
    return Mesh(n_data, n_model)
