"""Adam and its learning-rate schedule, as the JAX package's optax chain.

Counterpart of kpvid_tpu/train/state.py:

- the schedule is tf.train.exponential_decay(start * scale, 20000, 0.95,
  staircase=False), times min(1, (count + 1) / warmup_steps) when
  ``warmup_steps`` > 0. It is computed in float32 as optax computes it, so
  each step's rate is optax's value. optax applies ``schedule(count)`` with
  the count of updates made before this one: the first update uses
  ``start_val * scale``. That count is the optimizer's own (each
  parameter's Adam ``step``, kept in the checkpoint), which equals the
  trainer's ``step`` except after an import that starts a fresh Adam state
  at a later step (``import_tf1_checkpoint --step``); the logged ``lr`` is
  the schedule at the step, as JAX logs it;
- the optimizer is ``torch.optim.Adam(b1=0.5, b2=0.999, eps=1e-8)``, no
  weight decay: m_hat / (sqrt(v_hat) + eps), as optax.adam with no
  ``eps_root``. One optimizer for the generator, one for the discriminator,
  each over its own parameters.

The optimizer state is read and written as flat arrays
(``{prefix}.{name}.{exp_avg,exp_avg_sq,step}``) for the trainer's
checkpoint, so a resumed run continues with the same bits.
:class:`GANTrainer` holds what both stages' trainers share: the two
networks under one ``ModuleDict``, an Adam each, the step, the update with
the schedule's rate, the checkpoint's arrays, the data-parallel reductions
(:func:`make_reduce_hooks`), gradient accumulation and ``train_step_multi``.

``train_step_multi`` is JAX's: K 'fused' ``train_step``s over the K leading
slices of stacked arrays, the metrics stacked [K] and ``lr`` [K], the step
advanced by K (whatever ``grad_accum`` says, as JAX's scans ``train_step``).
On the CPU it is the loop of K eager steps. On the card it is one step
captured once as a CUDA graph (:class:`StepGraph`) and replayed K times:
a handful of launches a step where the eager step makes thousands. JAX's
has no data-parallel form, and gloo's collectives cannot be captured, so a
trainer on a mesh refuses it.

On a mesh with a 'model' axis (tensor parallelism) each process holds only
its shards of the arrays that parallel/sharding.py's rule shards, and Adam
runs on them: Adam is elementwise, so a shard's update is the slice of the
full update. The gradients of a shard, and of a replicated parameter, are
complete on every 'model' rank (parallel/tensor.py), so only the 'data'
axis reduces them. :meth:`GANTrainer.init_parameters` and the checkpoint's
arrays are full: :meth:`~GANTrainer.load_parameters` and
:meth:`~GANTrainer.load_state_arrays` cut them, and
:meth:`~GANTrainer.state_arrays` joins the shards (a collective of the
'model' group, which every rank calls).
"""

from __future__ import annotations

import contextlib
import gc
import warnings
from collections.abc import Callable, Mapping

import numpy as np
import torch
from torch import nn

from ..configs import LRConfig
from ..device import to_device
from ..models import init_like_jax
from ..parallel.sharding import gather_state, shard_modules, shard_state
from ..utils import jax_random

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
    tensors; before the first update, a fresh Adam's (zero moments, step 0)."""
    params = opt.param_groups[0]["params"]
    out = {}
    for name, p in zip(names, params):
        state = opt.state.get(p) or {"step": torch.tensor(0.0),
                                     "exp_avg": torch.zeros_like(p.detach()),
                                     "exp_avg_sq": torch.zeros_like(p.detach())}
        for key, val in state.items():
            out[f"{prefix}.{name}.{key}"] = torch.as_tensor(val).detach()
    return out


def update_count(opt: torch.optim.Optimizer) -> int:
    """The updates ``opt`` has made: the step of its first parameter's state
    (every parameter's is the same), 0 before the first."""
    state = opt.state.get(opt.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


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


def make_reduce_hooks(data_parallel: bool, grad_dtype: str, group=None):
    """(reduce_grads, reduce_metrics) of the data-parallel step
    (parallel/dp_step.py); identities when ``data_parallel`` is False.

    reduce_grads takes one network's gradients (f32, as every parameter),
    casts them to ``grad_dtype`` in one flat bucket, all-reduces it (sum)
    over ``group`` (the 'data' axis; None: every process), divides by the
    group's size in that dtype and gives
    the gradients back as f32 views of one buffer: JAX's
    ``pmean(g.astype(rdt)).astype(g.dtype)``.
    'bfloat16' is never done in f32: a backend that cannot sum bf16 fails.
    reduce_metrics is the f32 mean over the ranks of the local batch means,
    one all-reduce of the stacked scalars."""
    if not data_parallel:
        return (lambda grads: grads), (lambda metrics: metrics)
    import torch.distributed as dist

    rdt = torch.bfloat16 if grad_dtype == "bfloat16" else torch.float32

    n = dist.get_world_size(group)

    def reduce_grads(grads):
        # one cast and one cast back for the whole bucket, and views of it
        # for the gradients: a few host ops a tensor on a host-bound step
        flat = torch.cat([g.reshape(-1) for g in grads]).to(rdt)
        dist.all_reduce(flat, group=group)
        flat = (flat / n).to(grads[0].dtype)
        return [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def reduce_metrics(metrics):
        keys = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).float() for k in keys])
        dist.all_reduce(vals, group=group)
        return dict(zip(keys, (vals / n).unbind()))

    return reduce_grads, reduce_metrics


def _mean_metrics(history: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}


class StepGraph:
    """One 'fused' train step of a trainer on the card, captured as a CUDA
    graph, with its inputs, both optimizers' learning rates and its metrics
    in fixed device buffers; :meth:`run` replays it once a step.

    The graph holds the addresses of every tensor the step touches: the
    parameters, the BN statistics, the Adam moments and step counts, the
    buffers here. So nothing of these may be rebound while it lives
    (:meth:`valid` checks that the parameters, statistics and moments are
    the tensors captured; values copied in place are fine). Adam runs
    ``capturable`` in the graph: its step count a device tensor, its rate a
    device tensor copied in before each replay, its bias correction on the
    device in f32 (the eager step's is on the host in f64, so the two may
    differ by an ulp of the step size). Between calls Adam is eager again,
    with its step count a host tensor as the checkpoint code reads it.

    Capture needs eager warm-up steps first (cuDNN's plans, cuBLAS's
    workspace, Adam's moments, the cached grids of ops/coords.py); they move
    the parameters, statistics and moments, which are put back in place
    before the capture. The launch counters of the kernel wrappers count
    the warm-up and the capture, not the replays.

    It holds no reference to the trainer (which holds it), so it goes, and
    its graph with it, when the trainer does: a graph destroyed while
    another is being captured (by the garbage collector, breaking a cycle)
    would end that capture with an error. The collector is paused during
    the capture for the same reason."""

    WARMUP = 2

    def __init__(self, trainer: GANTrainer, example: dict[str, torch.Tensor]):
        self.device = trainer.device
        self.opts = (trainer.g_opt, trainer.d_opt)
        self.inputs = {n: v.clone() for n, v in example.items()}
        self.rates = torch.zeros(len(self.opts), device=self.device)
        self.steps: dict = {}  # parameter -> its Adam step count on the card
        step0 = trainer.step
        collecting = gc.isenabled()
        try:
            with self._capturable(trainer):
                saved = self._snapshot(trainer)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side), warnings.catch_warnings():
                    warnings.filterwarnings("ignore", "This instance was constructed with "
                                            "capturable=True")
                    for _ in range(self.WARMUP):
                        trainer._one_step(self.inputs)
                torch.cuda.current_stream(self.device).wait_stream(side)
                self._restore(trainer, saved)
                del saved
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()  # the graph's own pool takes what the warm-up held
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    gc.disable()
                    out = trainer._one_step(self.inputs)
                    self.keys = [k for k in out if k != "lr"]
                    self.metrics = torch.stack([out[k].float() for k in self.keys])
        finally:
            if collecting:
                gc.enable()
            trainer.step = step0
        self.captured = self._tensors(trainer)

    def _tensors(self, trainer: GANTrainer) -> list:
        model = trainer.model.state_dict(keep_vars=True)
        out = list(model.values())
        for opt in self.opts:
            for p in opt.param_groups[0]["params"]:
                state = opt.state.get(p, {})
                out += [state.get("exp_avg"), state.get("exp_avg_sq")]
        return out

    def valid(self, trainer: GANTrainer) -> bool:
        """The captured tensors are still the trainer's (none was rebound)."""
        now = self._tensors(trainer)
        return len(now) == len(self.captured) and all(a is b for a, b in zip(now, self.captured))

    @contextlib.contextmanager
    def _capturable(self, trainer: GANTrainer):
        """Adam in its capturable form within the block: the step counts on
        the card (the captured tensors), the rate in ``self.rates``; the
        trainer's ``_apply`` leaves the rate alone."""
        trainer._graphing = True
        for i, opt in enumerate(self.opts):
            for group in opt.param_groups:
                group["capturable"], group["lr"] = True, self.rates[i]
            for p, state in opt.state.items():
                step = self.steps.setdefault(p, torch.zeros((), device=p.device))
                step.copy_(state["step"])
                state["step"] = step
        try:
            yield
        finally:
            trainer._graphing = False
            for opt in self.opts:
                for p, state in opt.state.items():
                    self.steps[p] = state["step"]
                    state["step"] = state["step"].to("cpu", torch.float32)
                lr = trainer.lr_schedule(update_count(opt))
                for group in opt.param_groups:
                    group["capturable"], group["lr"] = False, lr

    def _snapshot(self, trainer: GANTrainer) -> tuple:
        model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        opts = [{p: {k: v.clone() for k, v in st.items()} for p, st in opt.state.items()}
                for opt in self.opts]
        return model, opts

    def _restore(self, trainer: GANTrainer, saved: tuple) -> None:
        """Put back what the warm-up moved, in place; Adam state that the
        warm-up created becomes a fresh optimizer's (zeros, step 0), which
        gives the first update's bits."""
        model, opts = saved
        for k, v in trainer.model.state_dict().items():
            v.copy_(model[k])
        for opt, before in zip(self.opts, opts):
            for p, state in opt.state.items():
                for k, v in state.items():
                    if p in before:
                        v.copy_(before[p][k])
                    else:
                        v.zero_()

    def run(self, t: GANTrainer, stacked: dict[str, torch.Tensor], k: int) -> dict:
        """K replays over the leading axis of ``stacked`` (device tensors)
        for the trainer ``t`` it was captured from; the metrics [K] on the
        card."""
        # optax's rate at its own count of updates, computed on the host as
        # the eager step computes it (never on the card: powf and numpy's
        # f32 power need not agree to the bit)
        rates = torch.tensor([[t.lr_schedule(update_count(opt) + i) for opt in self.opts]
                              for i in range(k)], dtype=torch.float32).to(self.device)
        logged = torch.tensor([t.lr_schedule(t.step + i + 1) for i in range(k)],
                              dtype=torch.float32)
        out = torch.empty(k, len(self.keys), device=self.device)
        with self._capturable(t):
            for i in range(k):
                for name, buf in self.inputs.items():
                    buf.copy_(stacked[name][i])
                self.rates.copy_(rates[i])
                self.graph.replay()
                out[i].copy_(self.metrics)
                t.step += 1
        return {**dict(zip(self.keys, out.unbind(1))), "lr": logged.to(self.device)}


class GANTrainer:
    """A generator and a discriminator keyed ``G_PREFIX.*`` and
    ``D_PREFIX.*`` in ``self.model``, each with its own Adam; subclasses set
    the prefixes and call :meth:`_setup` from their constructor.

    With a ``mesh`` (parallel/mesh.py) each update's gradients are averaged
    over its 'data' axis in ``training.dp_grad_dtype``, and the metrics in
    f32; ``data_index`` and ``data_size`` are this process's place on that
    axis. With a 'model' axis too, the arrays that ``parallel.min_shard_dim``
    selects are sharded (the module docstring)."""

    G_PREFIX = ""
    D_PREFIX = ""

    def _setup(self, generator: nn.Module, discriminator: nn.Module, config,
               device: torch.device, mesh=None) -> None:
        self.generator = generator
        self.discriminator = discriminator
        self.model = nn.ModuleDict({self.G_PREFIX: generator, self.D_PREFIX: discriminator})
        self.mesh = mesh
        self.shard = mesh.shard if mesh is not None else None
        self._full_shapes = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        self.param_rules = (shard_modules(self.model, self.shard, config.parallel.min_shard_dim)
                            if self.shard is not None else {})
        self.model.to(device)
        self._g_names, self._g_params = map(list, zip(*generator.named_parameters()))
        self._d_names, self._d_params = map(list, zip(*discriminator.named_parameters()))
        lr_cfg = config.training.lr
        self.g_opt = make_optimizer(self._g_params, lr_cfg)
        self.d_opt = make_optimizer(self._d_params, lr_cfg)
        self.lr_schedule = make_lr_schedule(lr_cfg)
        self.step = 0
        self._graphs: dict = {}  # input shapes -> StepGraph (train_step_multi on the card)
        self._graphing = False
        self.data_parallel = mesh is not None
        self.grad_accum = config.training.grad_accum
        self.data_index, self.data_size = (mesh.d, mesh.data) if mesh is not None else (0, 1)
        self._reduce_grads, self._reduce_metrics = make_reduce_hooks(
            self.data_parallel, config.training.dp_grad_dtype,
            mesh.data_group if mesh is not None else None)
        # the checkpoint's sharded arrays: the parameters' and their moments'
        self.array_rules = dict(self.param_rules)
        for opt, prefix, names in (("g_opt", self.G_PREFIX, self._g_names),
                                   ("d_opt", self.D_PREFIX, self._d_names)):
            for name in names:
                dim = self.param_rules.get(f"{prefix}.{name}")
                if dim is not None:
                    for key in ("exp_avg", "exp_avg_sq"):
                        self.array_rules[f"{opt}.{prefix}.{name}.{key}"] = dim

    def init_parameters(self, seed_or_key=0) -> dict[str, torch.Tensor]:
        """Both networks' full parameters (and BN statistics) as the JAX
        package's ``init_state(key)`` draws them, ``key`` ``PRNGKey(seed)``
        for an integer: the generator from the first key of ``split(key)``,
        the discriminator from the second (``models.init_like_jax``)."""
        g_key, d_key = jax_random.split(jax_random.as_key(seed_or_key))
        return init_like_jax(self.model, {self.G_PREFIX: g_key, self.D_PREFIX: d_key},
                             self._full_shapes)

    def load_parameters(self, params: dict) -> None:
        """Load full parameters (this rank keeps its shards)."""
        params = shard_state({k: torch.as_tensor(v) for k, v in params.items()},
                             self.param_rules, self.shard)
        self.model.load_state_dict(params, strict=True)

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """Everything a resumed run needs: the step, both networks (with any
        BN statistics) and both Adam states (the trainer checkpoint's
        arrays), full: under tensor parallelism a collective of the 'model'
        group that every rank must call."""
        out = {"step": torch.tensor(self.step, dtype=torch.int64)}
        out.update({k: v.detach() for k, v in self.model.state_dict().items()})
        out.update(optimizer_arrays(self.g_opt, self._g_names, f"g_opt.{self.G_PREFIX}"))
        out.update(optimizer_arrays(self.d_opt, self._d_names, f"d_opt.{self.D_PREFIX}"))
        return gather_state(out, self.array_rules, self.shard)

    def load_state_arrays(self, arrays) -> None:
        """Restore full arrays (:meth:`state_arrays`', a checkpoint's). Adam's
        state is new tensors, so a captured step graph is dropped."""
        self._graphs.clear()
        self.load_parameters({k: arrays[k] for k in self.model.state_dict()})
        arrays = shard_state(arrays, self.array_rules, self.shard)
        load_optimizer_arrays(self.g_opt, self._g_names, f"g_opt.{self.G_PREFIX}", arrays)
        load_optimizer_arrays(self.d_opt, self._d_names, f"d_opt.{self.D_PREFIX}", arrays)
        self.step = int(arrays["step"])

    def _apply(self, opt, params, grads) -> None:
        grads = self._reduce_grads(grads)
        if not self._graphing:  # the step graph copies each update's rate in (StepGraph)
            # optax: the schedule at its own count of updates made before this
            # one, not at the train step; the two part after a TF1 import, which
            # writes the step with a fresh Adam state
            lr = self.lr_schedule(update_count(opt))
            for group in opt.param_groups:
                group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None

    def _finish(self, d_metrics, g_metrics) -> dict:
        self.step += 1
        metrics = self._reduce_metrics({**d_metrics, **g_metrics})
        return {**metrics, "lr": self.lr_schedule(self.step)}

    def _micros(self, *xs: torch.Tensor) -> list[tuple]:
        """The rows of a batch's arrays split into ``grad_accum`` micros."""
        b = xs[0].shape[0]
        if b % self.grad_accum:
            raise ValueError(f"batch ({b} rows) must be divisible by grad_accum={self.grad_accum}")
        return list(zip(*(x.split(b // self.grad_accum) for x in xs)))

    def _accumulate(self, micros: list[tuple]) -> dict:
        """One 'fused' update from micros of ``(generator args, real)``:
        every micro's generator loss against the discriminator before the
        update, every discriminator loss against that micro's fake; the
        gradients summed, divided by the micro count, reduced once, then one
        Adam update per network. The metrics are the micros' means."""
        g_sum = d_sum = None
        g_hist, d_hist = [], []
        for g_args, real in micros:
            g_grads, fake, g_metrics = self.g_grads(*g_args)
            d_grads, d_metrics = self.d_grads(real, fake)
            g_sum = list(g_grads) if g_sum is None else [a + g for a, g in zip(g_sum, g_grads)]
            d_sum = list(d_grads) if d_sum is None else [a + g for a, g in zip(d_sum, d_grads)]
            g_hist.append(g_metrics)
            d_hist.append(d_metrics)
        k = len(micros)
        self._apply(self.g_opt, self._g_params, [a / k for a in g_sum])
        self._apply(self.d_opt, self._d_params, [a / k for a in d_sum])
        return self._finish(_mean_metrics(d_hist), _mean_metrics(g_hist))

    def _one_step(self, inputs: dict) -> dict:
        """One 'fused' ``train_step`` on one slice of :meth:`_multi`'s arrays."""
        raise NotImplementedError

    def _multi(self, stacked: dict) -> dict:
        """JAX's ``train_step_multi``: :meth:`_one_step` over the K leading
        slices of every array of ``stacked``; the metrics stacked [K]."""
        if self.mesh is not None:
            raise ValueError("train_step_multi has no data-parallel form (JAX's neither, and "
                             "gloo's collectives cannot be captured): run train_step on a mesh")
        ks = {len(v) for v in stacked.values()}
        if len(ks) != 1:
            raise ValueError(f"stacked arrays of different step counts: {sorted(ks)}")
        (k,) = ks
        if self.device.type != "cuda":
            history = [self._one_step({n: v[i] for n, v in stacked.items()}) for i in range(k)]
            return {key: torch.stack([torch.as_tensor(h[key], dtype=torch.float32)
                                      for h in history]) for key in history[0]}
        # on the card before the first replay: a host copy inside the graph
        # would replay from a stale pinned buffer
        stacked = {n: to_device(v, self.device, torch.float32) for n, v in stacked.items()}
        key = tuple((n, tuple(v.shape[1:])) for n, v in sorted(stacked.items()))
        graph = self._graphs.get(key)
        if graph is None or not graph.valid(self):
            self._graphs.pop(key, None)  # its pool goes before the new capture
            graph = self._graphs[key] = StepGraph(self, {n: v[0] for n, v in stacked.items()})
        return graph.run(self, stacked, k)
