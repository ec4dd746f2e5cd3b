"""The labeling dataset: whole videos, streamed as fixed-size chunks.

Copies kpvid_tpu/data/keypoint.py:

- ``VideoFramesDataset.iter_videos`` yields (video_id, n_frames,
  frames[n, S, S, 3]), center-cropped to ``image_size``;
- ``prefetch_videos`` decodes the next videos on a background thread while
  the device labels the current one;
- ``pack_chunks`` re-blocks the whole frame stream into [chunk, S, S, 3]
  slabs that span video boundaries (only the last slab of the run carries
  zero padding) and reports which rows belong to which video;
- ``chunk_frames`` is the per-video variant.

The pose encoder then sees one batch shape for any video length.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np

from . import augment
from .image_pair import load_frame, read_split, video_frame_count


class VideoFramesDataset:
    def __init__(self, data_dir: str, subset: str, image_size: int = 128,
                 as_uint8: bool = False, native_ops: str = "auto"):
        """as_uint8: keep frames as decoded uint8 pixels; the consumer maps
        them to [-1, 1] f32 on the device (u8 / 255 * 2 - 1, the formula this
        loader otherwise applies on the host: identical values), which
        quarters the bytes copied to the device. native_ops selects the
        byte-identical C++ resize (augment.FrameOps)."""
        self.data_dir = data_dir
        self.image_size = image_size
        self.as_uint8 = as_uint8
        self.ops = augment.resolve_frame_ops(native_ops)
        self.videos = read_split(data_dir, subset)

    def __len__(self) -> int:
        return len(self.videos)

    def video_id(self, idx: int) -> int:
        rel, _ = self.videos[idx]
        return int(rel.split("/")[-1])

    def load_video(self, idx: int) -> np.ndarray:
        """All frames, center-cropped to image_size: [-1, 1] f32, or raw
        uint8 pixels when as_uint8."""
        rel, _ = self.videos[idx]
        n = video_frame_count(self.data_dir, rel)
        ops = self.ops
        first = load_frame(self.data_dir, rel, 0).convert("RGB")
        box, ratio = augment.center_crop_box(first.size, self.image_size)
        w, h = first.size
        dtype = np.uint8 if self.as_uint8 else np.float32
        frames = np.empty((n, self.image_size, self.image_size, 3), dtype)
        for i in range(n):
            im = ops.prepare(load_frame(self.data_dir, rel, i).convert("RGB"))
            im = ops.crop(ops.resize(im, (int(w / ratio), int(h / ratio))), box)
            frames[i] = ops.to_u8(im) if self.as_uint8 else ops.to_unit(im)
        return frames if self.as_uint8 else frames * 2.0 - 1.0

    def iter_videos(self, shard_id: int = 0,
                    num_shards: int = 1) -> Iterator[tuple[int, int, np.ndarray]]:
        """Yield (video_id, n_frames, frames) for every video of the split, or
        of its stride ``shard_id::num_shards`` (a process of a multi-process
        labeler decodes only its own videos)."""
        for idx in range(shard_id, len(self.videos), num_shards):
            frames = self.load_video(idx)
            yield self.video_id(idx), frames.shape[0], frames


def chunk_frames(frames: np.ndarray, chunk: int) -> Iterator[np.ndarray]:
    """Re-block [N, ...] into fixed [chunk, ...] slabs, zero-padding the
    tail so every slab has the same shape."""
    n = frames.shape[0]
    for start in range(0, n, chunk):
        slab = frames[start : start + chunk]
        if slab.shape[0] < chunk:
            pad = np.zeros((chunk - slab.shape[0],) + frames.shape[1:], frames.dtype)
            slab = np.concatenate([slab, pad], axis=0)
        yield slab


def prefetch_videos(videos: Iterable[tuple[int, int, np.ndarray]],
                    depth: int = 2) -> Iterator[tuple[int, int, np.ndarray]]:
    """Run a video iterator on a daemon thread, ``depth`` items ahead, so the
    host decode of upcoming videos overlaps device work on the current one.
    An exception in the producer re-raises in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    end = object()

    def producer():
        try:
            for item in videos:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=producer, daemon=True, name="kpvid-decode").start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


# seg = (video_id, n_frames_in_video, frame_offset_in_video,
#        row_offset_in_slab, count)
Segment = tuple[int, int, int, int, int]


def pack_chunks(videos: Iterable[tuple[int, int, np.ndarray]],
                chunk: int) -> Iterator[tuple[np.ndarray, list[Segment]]]:
    """Pack a stream of (video_id, n_frames, frames) into fixed-shape
    [chunk, ...] slabs that span video boundaries, yielding each slab with
    the segments that scatter its rows back per video. Zero padding appears
    only in the last slab of the stream."""
    parts: list[np.ndarray] = []
    segs: list[Segment] = []
    filled = 0
    for vid, n, frames in videos:
        pos = 0
        while pos < n:
            take = min(chunk - filled, n - pos)
            parts.append(frames[pos : pos + take])
            segs.append((vid, n, pos, filled, take))
            filled += take
            pos += take
            if filled == chunk:
                yield np.concatenate(parts, axis=0), segs
                parts, segs, filled = [], [], 0
    if filled:
        pad = np.zeros((chunk - filled,) + parts[0].shape[1:], parts[0].dtype)
        yield np.concatenate(parts + [pad], axis=0), segs
