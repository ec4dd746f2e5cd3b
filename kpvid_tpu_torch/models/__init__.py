from .layers import BatchNorm, Conv, ConvBNReLU, Dense, StackedLSTM
from .networks import (
    ConvEncoder,
    ImageEncoder,
    MotionGenerator,
    PoseEncoder,
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
    "StackedLSTM",
    "Stage1Generator",
    "Translator",
]
