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
:class:`GANTrainer` holds what both stages' trainers share: the two
networks under one ``ModuleDict``, an Adam each, the step, the update with
the schedule's rate and the checkpoint's arrays.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..configs import LRConfig
from ..models import init_like_jax

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


class GANTrainer:
    """A generator and a discriminator keyed ``G_PREFIX.*`` and
    ``D_PREFIX.*`` in ``self.model``, each with its own Adam; subclasses set
    the prefixes and call :meth:`_setup` from their constructor."""

    G_PREFIX = ""
    D_PREFIX = ""

    def _setup(self, generator: nn.Module, discriminator: nn.Module, lr_cfg: LRConfig,
               device: torch.device) -> None:
        self.generator = generator
        self.discriminator = discriminator
        self.model = nn.ModuleDict({self.G_PREFIX: generator, self.D_PREFIX: discriminator})
        self.model.to(device)
        self._g_names, self._g_params = map(list, zip(*generator.named_parameters()))
        self._d_names, self._d_params = map(list, zip(*discriminator.named_parameters()))
        self.g_opt = make_optimizer(self._g_params, lr_cfg)
        self.d_opt = make_optimizer(self._d_params, lr_cfg)
        self.lr_schedule = make_lr_schedule(lr_cfg)
        self.step = 0

    def init_parameters(self, seed: int) -> dict[str, torch.Tensor]:
        """Both networks' parameters (and BN statistics) with the JAX
        package's init laws, drawn on the CPU from ``seed``."""
        return init_like_jax(self.model, seed)

    def load_parameters(self, params: dict) -> None:
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                                   strict=True)

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """Everything a resumed run needs: the step, both networks (with any
        BN statistics) and both Adam states (the trainer checkpoint's arrays)."""
        out = {"step": torch.tensor(self.step, dtype=torch.int64)}
        out.update({k: v.detach() for k, v in self.model.state_dict().items()})
        out.update(optimizer_arrays(self.g_opt, self._g_names, f"g_opt.{self.G_PREFIX}"))
        out.update(optimizer_arrays(self.d_opt, self._d_names, f"d_opt.{self.D_PREFIX}"))
        return out

    def load_state_arrays(self, arrays) -> None:
        self.load_parameters({k: arrays[k] for k in self.model.state_dict()})
        load_optimizer_arrays(self.g_opt, self._g_names, f"g_opt.{self.G_PREFIX}", arrays)
        load_optimizer_arrays(self.d_opt, self._d_names, f"d_opt.{self.D_PREFIX}", arrays)
        self.step = int(arrays["step"])

    def _apply(self, opt, params, grads) -> None:
        lr = self.lr_schedule(self.step)  # optax: the count before this update
        for group in opt.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None

    def _finish(self, d_metrics, g_metrics) -> dict:
        self.step += 1
        return {**d_metrics, **g_metrics, "lr": self.lr_schedule(self.step)}
