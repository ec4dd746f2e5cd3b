from .layers import BatchNorm, Conv, ConvBNReLU, Dense, StackedLSTM, init_like_jax
from .networks import (
    ConvEncoder,
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
    "ImageEncoder",
    "MotionGenerator",
    "PoseEncoder",
    "SeqDiscriminator",
    "StackedLSTM",
    "Stage1Generator",
    "Translator",
    "init_like_jax",
]
