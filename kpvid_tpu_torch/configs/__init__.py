from .config import (
    Config,
    DataConfig,
    LRConfig,
    ModelConfig,
    ParallelConfig,
    PathsConfig,
    TrainingConfig,
    load_config,
)

__all__ = ["Config", "DataConfig", "LRConfig", "ModelConfig", "ParallelConfig", "PathsConfig",
           "TrainingConfig", "load_config"]
