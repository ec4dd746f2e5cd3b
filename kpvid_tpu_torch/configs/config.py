"""The configuration fields the port reads, loadable from the same YAML files.

Counterpart of kpvid_tpu/configs/config.py (ModelConfig, the
``training.compute_dtype`` field and ``validate``'s shape checks). The YAML
schema is the JAX package's: ``model`` keys are checked strictly, the
sections and ``training`` keys that the port does not read yet are accepted
and left unread.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

# top-level YAML sections of the full schema; only `model` and
# `training.compute_dtype` are read here
_SECTIONS = ("paths", "training", "model", "data", "parallel")


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
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)

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


def load_config(path: str | Path) -> Config:
    """Load a YAML config of the kpvid_tpu schema."""
    import yaml  # only the loader needs it, not the generation path

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    unknown = set(raw) - set(_SECTIONS)
    if unknown:
        raise ValueError(f"unknown config section(s) {sorted(unknown)}")
    training = raw.get("training") or {}
    cfg = Config(
        training=TrainingConfig(
            compute_dtype=training.get("compute_dtype", TrainingConfig.compute_dtype)
        ),
        model=_model_config(raw.get("model") or {}),
    )
    return cfg.validate()
