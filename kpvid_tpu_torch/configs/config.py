"""The configuration fields the port reads, loadable from the same YAML files.

Counterpart of kpvid_tpu/configs/config.py: ModelConfig, ``paths.data_dir``,
``paths.vggnet`` and ``paths.log_dir``, the ``training`` fields of both
trainers (with ``LRConfig``), the ``data`` fields of the pipelines (stage
1's ``decode_cache_mb`` among them), ``parallel``, and ``validate``'s checks
of them. The YAML schema is the JAX package's: ``model`` and ``training.lr``
keys are checked strictly; of the other sections' keys, the one the port
has no use for (``data.min_image_seq_len``, the reference's pad length,
which the chunked labeler does not pad to) is accepted and left unread.
``parallel`` lays the run's processes out as a ('data', 'model') mesh
(parallel/mesh.py); ``validate`` takes JAX's checks of it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

# top-level YAML sections of the full schema; `model` is read whole, the
# other sections for the fields of the dataclasses below
_SECTIONS = ("paths", "training", "model", "data", "parallel")


@dataclasses.dataclass
class PathsConfig:
    data_dir: str = "./data/penn"
    # the reference's VGG19 weights; stage 1 synthesizes frozen stand-ins
    # when the file is absent
    vggnet: str = "./data/vgg19.npy"
    log_dir: str = "results/"


@dataclasses.dataclass
class DataConfig:
    # the host C++ resize (kpvid_tpu_torch/native), byte-identical to PIL:
    # 'auto' = use it when it builds and verifies; 'on' = require it;
    # 'off' = PIL only
    native_ops: str = "auto"
    # frames per chunk streamed through the pose encoder by the labeler
    labeler_chunk: int = 128
    synthetic: bool = False
    # HostDataPipeline worker threads; None -> min(12, 4 * cpu_count)
    num_workers: int | None = None
    prefetch: int = 2
    # stage 1's decoded-frame LRU budget in MB (data/cache.py); 0 = off.
    # Exact: it keeps the decoded RGB pixels
    decode_cache_mb: float = 0.0
    sequence_len: int = 33
    eval_batch_size: int = 8


@dataclasses.dataclass
class LRConfig:
    # Adam 1e-4, exponential decay x0.95 every 20k steps, not staircase
    start_val: float = 1e-4
    step: int = 20_000
    decay: float = 0.95
    scale: float = 1.0
    warmup_steps: int = 0


@dataclasses.dataclass
class TrainingConfig:
    compute_dtype: str = "bfloat16"  # 'bfloat16' or 'float32'
    n_steps: int = 30_000_000
    summary_interval: int = 500
    test_interval: int = 500
    checkpoint_interval: int = 20_000
    log_interval: int = 250
    batch_size: int = 16
    lr: LRConfig = dataclasses.field(default_factory=LRConfig)
    seed: int = 0
    # 'fused' | 'fused_dg' | 'two_batch' (train/stage2.py)
    gan_step_mode: str = "fused"
    keep_checkpoints: int | None = None
    resume: bool = True
    # discriminator pair layout (ops/batching.py): 'auto' | 'concat' | 'interleave'
    pair_batching: str = "auto"
    # stage 1: recompute the frozen VGG tower in the backward
    # (torch.utils.checkpoint) instead of keeping its activations
    remat_vgg: bool = False
    # stage 1's BN in the test sweeps and in the summary images: 'inference'
    # (moving averages) or 'train' (the batch's statistics, never kept)
    bn_eval_mode: str = "inference"
    summary_bn_mode: str = "inference"
    # 'fused' only: one update from K micros of batch_size / K rows
    grad_accum: int = 1
    # the data-parallel gradient all-reduce: 'float32' or 'bfloat16' (half
    # the bytes; parallel/dp_step.py)
    dp_grad_dtype: str = "float32"


@dataclasses.dataclass
class ModelConfig:
    n_pts: int = 40
    n_action: int = 9
    cell_info: tuple[int, ...] = (1024, 1024)
    vae_dim: int = 64
    image_size: int = 128
    n_future_frames: int = 32
    heatmap_inv_std: float = 14.3
    heatmap_size: int = 32
    encoder_filters: int = 32
    translator_filters: int = 256
    pose_decoder_filters: int = 128
    discriminator_filters: int = 64
    upsample_mode: str = "tf1"
    lstm_unroll: int = 1


@dataclasses.dataclass
class ParallelConfig:
    # processes whose gradients are averaged; None = all of them
    mesh_data: int | None = None
    # tensor parallelism: processes that share each data coordinate's rows
    # and hold the shards of the wide arrays (parallel/sharding.py)
    mesh_model: int = 1
    # narrower arrays stay replicated
    min_shard_dim: int = 1024


@dataclasses.dataclass
class Config:
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def validate(self) -> "Config":
        m, t = self.model, self.training
        if m.n_pts <= 0 or m.n_action <= 0:
            raise ValueError("model.n_pts and model.n_action must be positive")
        if m.image_size != 4 * m.heatmap_size:
            raise ValueError(
                f"image_size ({m.image_size}) must be exactly 4 * heatmap_size "
                f"({m.heatmap_size}): the translator has two 2x upsample octaves"
            )
        if m.image_size % 8:
            raise ValueError(
                f"image_size ({m.image_size}) must be a multiple of 8: the "
                "encoder trunk has three stride-2 octaves"
            )
        if self.data.native_ops not in ("auto", "on", "off"):
            raise ValueError(
                f"data.native_ops must be auto|on|off, got {self.data.native_ops!r}"
            )
        if self.data.labeler_chunk <= 0:
            raise ValueError("data.labeler_chunk must be positive")
        if t.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {t.compute_dtype!r}")
        if t.gan_step_mode not in ("fused", "fused_dg", "two_batch"):
            raise ValueError(f"unknown gan_step_mode {t.gan_step_mode!r}")
        if t.pair_batching not in ("auto", "interleave", "concat"):
            raise ValueError(f"unknown pair_batching {t.pair_batching!r}")
        if t.bn_eval_mode not in ("inference", "train"):
            raise ValueError(f"unknown bn_eval_mode {t.bn_eval_mode!r}")
        if t.summary_bn_mode not in ("inference", "train"):
            raise ValueError(f"unknown summary_bn_mode {t.summary_bn_mode!r}")
        if m.upsample_mode not in ("tf1", "matmul", "fused"):
            raise ValueError(f"unknown model.upsample_mode {m.upsample_mode!r}")
        if m.lstm_unroll < 1:
            raise ValueError("model.lstm_unroll must be >= 1")
        if t.lr.scale <= 0:
            raise ValueError("training.lr.scale must be positive")
        if t.lr.warmup_steps < 0:
            raise ValueError("training.lr.warmup_steps must be >= 0")
        if t.dp_grad_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dp_grad_dtype {t.dp_grad_dtype!r}")
        if t.grad_accum < 1:
            raise ValueError("training.grad_accum must be >= 1")
        if t.grad_accum > 1:
            if t.batch_size % t.grad_accum:
                raise ValueError(
                    f"batch_size ({t.batch_size}) must be divisible by "
                    f"grad_accum ({t.grad_accum})"
                )
            if t.gan_step_mode != "fused":
                raise ValueError(
                    "grad_accum > 1 implements the 'fused' step semantics "
                    f"only (got gan_step_mode={t.gan_step_mode!r})"
                )
        if t.dp_grad_dtype == "bfloat16" and self.parallel.mesh_model > 1:
            raise ValueError(
                "training.dp_grad_dtype='bfloat16' is pure-DP only "
                "(parallel.mesh_model must be 1; see parallel/dp_step.py)"
            )
        if t.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        p = self.parallel
        if p.mesh_model < 1 or (p.mesh_data is not None and p.mesh_data < 1):
            raise ValueError("parallel.mesh_data/mesh_model must be >= 1")
        return self


def _model_config(raw: dict[str, Any]) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise ValueError(f"unknown config key(s) {sorted(unknown)} for ModelConfig")
    kwargs = dict(raw)
    if "cell_info" in kwargs:
        kwargs["cell_info"] = tuple(int(v) for v in kwargs["cell_info"])
    return ModelConfig(**kwargs)


def _known(cls, raw: dict[str, Any]):
    """The fields of ``cls`` that ``raw`` sets; its other keys are left unread."""
    return cls(**{f.name: raw[f.name] for f in dataclasses.fields(cls) if f.name in raw})


def _training_config(raw: dict[str, Any]) -> TrainingConfig:
    raw = dict(raw)
    lr = raw.pop("lr", None) or {}
    unknown = set(lr) - {f.name for f in dataclasses.fields(LRConfig)}
    if unknown:
        raise ValueError(f"unknown config key(s) {sorted(unknown)} for LRConfig")
    return dataclasses.replace(_known(TrainingConfig, raw), lr=LRConfig(**lr))


def load_config(path: str | Path) -> Config:
    """Load a YAML config of the kpvid_tpu schema."""
    import yaml  # only the loader needs it, not the generation path

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    unknown = set(raw) - set(_SECTIONS)
    if unknown:
        raise ValueError(f"unknown config section(s) {sorted(unknown)}")
    cfg = Config(
        paths=_known(PathsConfig, raw.get("paths") or {}),
        training=_training_config(raw.get("training") or {}),
        model=_model_config(raw.get("model") or {}),
        data=_known(DataConfig, raw.get("data") or {}),
        parallel=_known(ParallelConfig, raw.get("parallel") or {}),
    )
    return cfg.validate()
