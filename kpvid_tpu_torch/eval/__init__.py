from .final import FinalGenerator
from .server import InferenceEngine, device_quantize, request_z, to_uint8

__all__ = ["FinalGenerator", "InferenceEngine", "device_quantize", "request_z", "to_uint8"]
