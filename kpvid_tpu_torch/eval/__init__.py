from .final import FinalGenerator
from .server import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    MicroBatcher,
    device_quantize,
    encode_gif,
    encode_npz,
    make_server,
    preprocess_image,
    request_z,
    to_uint8,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "FinalGenerator",
    "InferenceEngine",
    "MicroBatcher",
    "device_quantize",
    "encode_gif",
    "encode_npz",
    "make_server",
    "preprocess_image",
    "request_z",
    "to_uint8",
]
