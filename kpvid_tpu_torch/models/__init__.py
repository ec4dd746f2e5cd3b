from .layers import (
    BatchNorm,
    Conv,
    ConvBNReLU,
    Dense,
    StackedLSTM,
    init_like_jax,
    syncing_batch_stats,
    updating_batch_stats,
)
from .networks import (
    ConvEncoder,
    ImageDiscriminator,
    ImageEncoder,
    MotionGenerator,
    PoseEncoder,
    SeqDiscriminator,
    Stage1Generator,
    Translator,
)

__all__ = [
    "BatchNorm",
    "Conv",
    "ConvBNReLU",
    "ConvEncoder",
    "Dense",
    "ImageDiscriminator",
    "ImageEncoder",
    "MotionGenerator",
    "PoseEncoder",
    "SeqDiscriminator",
    "StackedLSTM",
    "Stage1Generator",
    "Translator",
    "init_like_jax",
    "syncing_batch_stats",
    "updating_batch_stats",
]
