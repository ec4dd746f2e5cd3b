from .config import Config, DataConfig, ModelConfig, PathsConfig, TrainingConfig, load_config

__all__ = ["Config", "DataConfig", "ModelConfig", "PathsConfig", "TrainingConfig", "load_config"]
