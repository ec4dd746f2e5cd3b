from .base import HostDataPipeline, device_prefetch
from .image_pair import ImagePairDataset
from .keypoint import VideoFramesDataset, chunk_frames, pack_chunks, prefetch_videos
from .sequence import SequenceDataset
from .synthetic import make_synthetic_penn_tree, make_synthetic_pseudo_labels

__all__ = [
    "HostDataPipeline",
    "ImagePairDataset",
    "SequenceDataset",
    "VideoFramesDataset",
    "chunk_frames",
    "device_prefetch",
    "make_synthetic_penn_tree",
    "make_synthetic_pseudo_labels",
    "pack_chunks",
    "prefetch_videos",
]
