"""The configuration fields the port reads, loadable from the same YAML files.

Counterpart of kpvid_tpu/configs/config.py (ModelConfig, the
``training.compute_dtype`` field, ``paths.data_dir``, the ``data`` fields
of serving and labeling, and ``validate``'s checks of them). The YAML
schema is the JAX package's: ``model`` keys are checked strictly, the
sections and the ``paths``, ``training`` and ``data`` keys that the port
does not read yet are accepted and left unread.
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


@dataclasses.dataclass
class DataConfig:
    # the host C++ resize (kpvid_tpu_torch/native), byte-identical to PIL:
    # 'auto' = use it when it builds and verifies; 'on' = require it;
    # 'off' = PIL only
    native_ops: str = "auto"
    # frames per chunk streamed through the pose encoder by the labeler
    labeler_chunk: int = 128
    synthetic: bool = False


@dataclasses.dataclass
class TrainingConfig:
    compute_dtype: str = "bfloat16"  # 'bfloat16' or 'float32'


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
class Config:
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

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
        training=_known(TrainingConfig, raw.get("training") or {}),
        model=_model_config(raw.get("model") or {}),
        data=_known(DataConfig, raw.get("data") or {}),
    )
    return cfg.validate()
