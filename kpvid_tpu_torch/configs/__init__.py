from .config import Config, ModelConfig, TrainingConfig, load_config

__all__ = ["Config", "ModelConfig", "TrainingConfig", "load_config"]
