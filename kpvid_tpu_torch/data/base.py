"""Host data pipeline: worker threads sample, the consumer batches in order.

A copy of kpvid_tpu/data/base.py: a pool of threads runs
the dataset's ``sample(idx, rng)`` (PIL and the native kernels release the
GIL), the consumer puts the results back in sequence order and stacks
fixed-shape numpy batches, and bounded queues give prefetch back-pressure.
It is deterministic: each epoch's order is seeded by (seed, epoch) and each
sample's rng by (seed, epoch, idx), so the batches do not depend on the
worker count or the scheduling, and ``start_sample`` resumes the exact
stream an interrupted run would have produced. ``shard_id``/``num_shards``
give a process of a data-parallel run its strided part of every epoch
(parallel/distributed.py).

``device_prefetch`` moves batches to the device ``size`` steps ahead of the
consumer: each array is staged in pinned memory and copied without blocking
the host (device.py::to_device).

Datasets implement ``__len__()`` and ``sample(idx, rng) -> dict of arrays``.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from collections.abc import Iterator
from typing import Protocol

import numpy as np
import torch

from ..device import to_device


class Dataset(Protocol):
    def __len__(self) -> int: ...

    def sample(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]: ...


def _stack(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}


_SENTINEL = object()


class HostDataPipeline:
    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        repeat: bool = False,
        num_workers: int | None = None,
        prefetch: int = 2,
        seed: int = 0,
        drop_remainder: bool | None = None,
        shard_id: int = 0,
        num_shards: int = 1,
        start_sample: int = 0,
        shard_granularity: str = "sample",
    ):
        """shard_id/num_shards: this process's shard of a data-parallel run.
        Every process draws the same seeded permutation and takes a strided
        part of it, so the shards partition each epoch.

        shard_granularity: 'sample' strides single indices (training: each
        process feeds its local rows of every global batch); 'batch' strides
        whole ``batch_size`` chunks, so the shard's batches are exactly the
        single-process run's batches shard_id, shard_id + num_shards, ...
        (evaluate, whose outputs per batch must be the one-process run's).

        start_sample: resume the index stream after this many consumed
        samples of the shard (train/cli.py passes step * local batch size).
        drop_remainder defaults to ``repeat``: training wants static shapes,
        an evaluation sweep every sample."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat = repeat
        if num_workers is None:
            num_workers = min(12, 4 * (os.cpu_count() or 1))
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if shard_granularity not in ("sample", "batch"):
            raise ValueError(f"unknown shard_granularity {shard_granularity!r}")
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shard_granularity = shard_granularity
        self.start_sample = start_sample
        self.drop_remainder = repeat if drop_remainder is None else drop_remainder

    def _shard(self, idxs: np.ndarray) -> np.ndarray:
        if self.num_shards == 1:
            return idxs
        if self.shard_granularity == "batch":
            b = self.batch_size
            own = [idxs[i:i + b] for i in range(0, len(idxs), b)][self.shard_id::self.num_shards]
            return np.concatenate(own) if own else idxs[:0]
        return idxs[self.shard_id::self.num_shards]

    def _index_stream(self) -> Iterator[tuple[int, int]]:
        n = len(self.dataset)
        shard_len = len(self._shard(np.arange(n)))
        epoch, offset = (divmod(self.start_sample, shard_len) if self.start_sample and shard_len
                         else (0, 0))
        while True:
            order_rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            idxs = order_rng.permutation(n) if self.shuffle else np.arange(n)
            for i in self._shard(idxs)[offset:]:
                yield epoch, int(i)
            offset = 0
            epoch += 1
            if not self.repeat:
                return

    def samples(self) -> Iterator[dict[str, np.ndarray]]:
        """Yield single samples in deterministic sequence order."""
        in_q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch * self.batch_size
                                         + self.num_workers)
        stop = threading.Event()

        def _put(q, item) -> bool:
            """A put that gives up when the consumer is gone, so every thread
            stops on its own."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _SENTINEL:
                    _put(in_q, _SENTINEL)
                    return
                seq, epoch, idx = item
                rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, idx]))
                try:
                    result = self.dataset.sample(idx, rng)
                except Exception as e:  # noqa: BLE001 - raised again by the consumer
                    result = e
                _put(out_q, (seq, result))

        def feeder():
            seq = 0
            for epoch, idx in self._index_stream():
                if not _put(in_q, (seq, epoch, idx)):
                    return
                seq += 1
            _put(in_q, _SENTINEL)
            _put(out_q, (seq, _SENTINEL))  # the end marker carries the total

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        threads.append(threading.Thread(target=feeder, daemon=True))
        for t in threads:
            t.start()
        try:
            pending: dict[int, object] = {}
            next_seq = 0
            total = None
            while total is None or next_seq < total:
                if next_seq in pending:
                    result = pending.pop(next_seq)
                    if isinstance(result, Exception):
                        raise result
                    yield result
                    next_seq += 1
                    continue
                seq, result = out_q.get()
                if result is _SENTINEL:
                    total = seq
                    continue
                pending[seq] = result
        finally:
            stop.set()  # every thread polls the flag

    def batches(self) -> Iterator[dict[str, np.ndarray]]:
        buf: list[dict] = []
        for sample in self.samples():
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield _stack(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield _stack(buf)


def device_prefetch(batches: Iterator[dict], device: torch.device,
                    size: int = 2) -> Iterator[dict[str, torch.Tensor]]:
    """Batches as tensors on ``device``, copied ``size`` batches ahead of the
    consumer."""
    ahead: collections.deque = collections.deque()
    it = iter(batches)

    def put(batch):
        return {k: to_device(v, device) for k, v in batch.items()}

    for batch in it:
        ahead.append(put(batch))
        if len(ahead) >= size:
            break
    while ahead:
        out = ahead.popleft()
        nxt = next(it, None)
        if nxt is not None:
            ahead.append(put(nxt))
        yield out
