from .base import HostDataPipeline, device_prefetch
from .keypoint import VideoFramesDataset, chunk_frames, pack_chunks, prefetch_videos
from .sequence import SequenceDataset
from .synthetic import make_synthetic_penn_tree, make_synthetic_pseudo_labels

__all__ = [
    "HostDataPipeline",
    "SequenceDataset",
    "VideoFramesDataset",
    "chunk_frames",
    "device_prefetch",
    "make_synthetic_penn_tree",
    "make_synthetic_pseudo_labels",
    "pack_chunks",
    "prefetch_videos",
]
