from .keypoint import VideoFramesDataset, chunk_frames, pack_chunks, prefetch_videos
from .synthetic import make_synthetic_penn_tree

__all__ = [
    "VideoFramesDataset",
    "chunk_frames",
    "make_synthetic_penn_tree",
    "pack_chunks",
    "prefetch_videos",
]
