"""Adam and its learning-rate schedule, as the JAX package's optax chain.

Counterpart of kpvid_tpu/train/state.py:

- the schedule is tf.train.exponential_decay(start * scale, 20000, 0.95,
  staircase=False), times min(1, (count + 1) / warmup_steps) when
  ``warmup_steps`` > 0. It is computed in float32 as optax computes it, so
  each step's rate is optax's value. optax applies ``schedule(count)`` with
  the count of updates made before this one: the first update uses
  ``start_val * scale``;
- the optimizer is ``torch.optim.Adam(b1=0.5, b2=0.999, eps=1e-8)``, no
  weight decay: m_hat / (sqrt(v_hat) + eps), as optax.adam with no
  ``eps_root``. One optimizer for the generator, one for the discriminator,
  each over its own parameters.

The optimizer state is read and written as flat arrays
(``{prefix}.{name}.{exp_avg,exp_avg_sq,step}``) for the trainer's
checkpoint, so a resumed run continues with the same bits.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import numpy as np
import torch

from ..configs import LRConfig

ADAM_BETAS = (0.5, 0.999)
ADAM_EPS = 1e-8
_ADAM_KEYS = ("exp_avg", "exp_avg_sq", "step")


def make_lr_schedule(lr_cfg: LRConfig) -> Callable[[int], float]:
    """count -> learning rate, float32 arithmetic as in optax."""
    init = np.float32(lr_cfg.start_val * lr_cfg.scale)
    decay = np.float32(lr_cfg.decay)
    steps = np.float32(lr_cfg.step)
    warmup = float(lr_cfg.warmup_steps)

    def schedule(count: int) -> float:
        c = np.float32(count)
        value = init if count <= 0 else init * np.power(decay, c / steps)
        if warmup > 0:
            value = np.float32(value) * np.minimum(np.float32(1.0), (c + np.float32(1.0))
                                                   / np.float32(warmup))
        return float(np.float32(value))

    return schedule


def make_optimizer(params, lr_cfg: LRConfig) -> torch.optim.Adam:
    """Adam over ``params``; the trainer sets each update's rate from the
    schedule."""
    return torch.optim.Adam(list(params), lr=lr_cfg.start_val * lr_cfg.scale,
                            betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0)


def optimizer_arrays(opt: torch.optim.Optimizer, names: list[str],
                     prefix: str) -> dict[str, torch.Tensor]:
    """The optimizer's per-parameter state as ``{prefix}.{name}.{key}``
    tensors (empty before the first update)."""
    params = opt.param_groups[0]["params"]
    out = {}
    for name, p in zip(names, params):
        for key, val in opt.state.get(p, {}).items():
            out[f"{prefix}.{name}.{key}"] = torch.as_tensor(val).detach()
    return out


def load_optimizer_arrays(opt: torch.optim.Optimizer, names: list[str], prefix: str,
                          arrays: Mapping) -> None:
    """Restore what :func:`optimizer_arrays` wrote; the step count stays a
    float32 host tensor, as torch.optim.Adam keeps it."""
    params = opt.param_groups[0]["params"]
    for name, p in zip(names, params):
        keys = [f"{prefix}.{name}.{k}" for k in _ADAM_KEYS]
        if not all(k in arrays for k in keys):
            raise ValueError(f"checkpoint lacks the optimizer state of {prefix}.{name}")
        exp_avg, exp_avg_sq, step = (torch.as_tensor(np.asarray(arrays[k])) for k in keys)
        opt.state[p] = {
            "step": step.to(torch.float32).reshape(()),
            "exp_avg": exp_avg.to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": exp_avg_sq.to(device=p.device, dtype=p.dtype).clone(),
        }
