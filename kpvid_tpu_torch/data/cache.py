"""Host-side decoded-frame cache of stage 1's ``ImagePairDataset``.

Copy of kpvid_tpu/data/cache.py. Training redraws frames uniformly at
random across epochs, so a byte-budgeted LRU of decoded RGB frames
(``data.decode_cache_mb``) turns a repeat visit's JPEG decode into an
``Image.fromarray``. It is exact: the cache keeps the pixels after
``convert("RGB")``, and every augmentation step runs on the same input
either way. The pipeline's worker threads share one cache; every change
of the map happens under a lock, and a miss decodes outside it, so misses
on different frames overlap.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
from PIL import Image


class FrameCache:
    """Byte-budgeted LRU of decoded frames keyed by (video, frame_idx)."""

    def __init__(self, budget_mb: float):
        self.budget = int(budget_mb * 2**20)
        self._map: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple, decode) -> Image.Image:
        """Return the decoded frame for `key`, calling `decode() ->
        PIL.Image` (already RGB) on a miss. Decode runs OUTSIDE the lock so
        concurrent misses on different frames overlap."""
        with self._lock:
            arr = self._map.get(key)
            if arr is not None:
                self._map.move_to_end(key)
                self.hits += 1
                return Image.fromarray(arr)
            self.misses += 1
        im = decode()
        arr = np.asarray(im, dtype=np.uint8)
        arr.flags.writeable = False
        with self._lock:
            if key not in self._map:
                self._map[key] = arr
                self._bytes += arr.nbytes
                while self._bytes > self.budget and len(self._map) > 1:
                    _, old = self._map.popitem(last=False)
                    self._bytes -= old.nbytes
        return im

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._map),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
            }
