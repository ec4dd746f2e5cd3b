"""Generation, serving and the serving artifact.

Names are imported from their modules on first use, so that loading and
serving an artifact (``export``, ``server``) imports no model code.
"""

import importlib

_MODULES = {
    "FinalGenerator": "final",
    "ArtifactEngine": "server",
    "DEFAULT_BUCKETS": "server",
    "InferenceEngine": "server",
    "MicroBatcher": "server",
    "device_quantize": "server",
    "encode_gif": "server",
    "encode_npz": "server",
    "make_server": "server",
    "preprocess_image": "server",
    "request_z": "server",
    "to_uint8": "server",
    "ServingArtifact": "export",
    "export_serving": "export",
    "load_serving": "export",
}


def __getattr__(name: str):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_MODULES[name]}", __name__), name)


__all__ = sorted(_MODULES)
