"""The multi-process train step: explicit gradient all-reduce in f32 or bf16,
and tensor parallelism over a 'model' axis.

Counterpart of kpvid_tpu/parallel/dp_step.py, and of the jitted step on a
('data', 'model') mesh that kpvid_tpu/train.py runs with
``shard_state``. Each process holds its local rows and both networks and
both Adams, whole on a pure-DP mesh, and runs the trainers' unchanged step
functions with the reductions switched on (the trainers' ``mesh``):

- gradients: after each ``torch.autograd.grad``, one flat bucket per network
  cast to ``training.dp_grad_dtype``, all-reduced (sum), divided by the
  world size in that dtype and cast back to f32, the unchanged f32 Adam
  after it: ``pmean(g.astype(rdt)).astype(g.dtype)`` (train/state.py::
  make_reduce_hooks). 'bfloat16' halves the bytes on the wire;
- stage-1 BN: sync-BN, the batch statistics averaged over the ranks in
  every training forward, differentiably (models/layers.py); the running
  statistics stay equal on every rank;
- stage-2 VAE noise: drawn for the global batch by every rank and sliced
  by rank (Stage2Trainer), the stream of the single-process step;
- metrics: an f32 mean over the ranks of the local batch means.

With a 'model' axis of M > 1 every reduction above runs over the 'data'
axis only, and the M processes of one data coordinate, which feed the same
rows, hold the shards of the arrays that ``parallel.min_shard_dim`` selects
(train/state.py; column-parallel layers, parallel/tensor.py).
``dp_grad_dtype='bfloat16'`` stays pure-DP, as in JAX.

``DistributedDataParallel`` is not used: the trainers take
``torch.autograd.grad`` over one network's parameters, and DDP's reducer
fires only on ``.backward()``. The parameters, the state arrays and the
checkpoints are the single-process trainer's, in both directions.
"""

from __future__ import annotations

import copy

import torch.distributed as dist

from .mesh import Mesh, make_mesh

MODES = ("fused", "fused_dg", "two_batch")


def select_step(trainer, mode: str, grad_accum: int):
    """The trainer's step function for ``mode``; 'fused' accumulates
    ``grad_accum`` micros when it is above 1 (train.py's choice)."""
    if mode not in MODES:
        raise ValueError(f"unknown gan_step_mode {mode!r}")
    if mode == "fused":
        return trainer.train_step_accum if grad_accum > 1 else trainer.train_step
    return trainer.train_step_dg if mode == "fused_dg" else trainer.train_step_two_batch


def make_dp_reduce_step(config, stage: int, mesh: Mesh | None = None,
                        vgg_params: dict | None = None, mode: str | None = None,
                        device="cuda"):
    """Build the multi-process trainer of ``stage`` (1 or 2) on ``mesh``
    (default: every process on the 'data' axis) and return ``(trainer,
    step)``, ``step`` with the signature of the trainer's step of ``mode``
    (default ``training.gan_step_mode``). The gradient reduction dtype is
    ``training.dp_grad_dtype``."""
    mesh = mesh or make_mesh(config.parallel.mesh_data, config.parallel.mesh_model)
    if mesh.model != 1 and config.training.dp_grad_dtype == "bfloat16":
        raise ValueError(
            "make_dp_reduce_step with dp_grad_dtype='bfloat16' is pure-DP only: mesh has "
            f"a 'model' axis of size {mesh.model}"
        )
    mode = mode or config.training.gan_step_mode
    if mode not in MODES:
        raise ValueError(f"unknown gan_step_mode {mode!r}")
    if not dist.is_initialized():
        raise RuntimeError("the data-parallel step needs a process group: call "
                           "parallel.maybe_initialize() with the KPVID_* environment first")
    # every pair-batch site is rank-local, so 'auto' takes the 'concat'
    # layout (ops/batching.py); an explicit setting is respected
    if config.training.pair_batching == "auto":
        config = copy.deepcopy(config)
        config.training.pair_batching = "concat"
    if stage == 1:
        from ..train.stage1 import Stage1Trainer

        if vgg_params is None:
            raise ValueError("stage 1 needs vgg_params")
        trainer = Stage1Trainer(config, vgg_params, device=device, mesh=mesh)
    elif stage == 2:
        from ..train.stage2 import Stage2Trainer

        trainer = Stage2Trainer(config, device=device, mesh=mesh)
    else:
        raise ValueError(f"stage must be 1 or 2, got {stage!r}")
    return trainer, select_step(trainer, mode, config.training.grad_accum)
