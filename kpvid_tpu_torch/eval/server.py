"""The serving daemon: micro-batched video generation over HTTP.

Counterpart of kpvid_tpu/eval/server.py (``preprocess_image``,
``request_z``, ``to_uint8``, ``device_quantize``, ``encode_gif``, the npz
body as ``encode_npz``, ``InferenceEngine``, ``MicroBatcher``, the HTTP handler and
``make_server``, and ``ArtifactEngine``, the daemon's engine over a
one-file serving artifact, eval/export.py); mesh serving is not ported.

- ``InferenceEngine`` maps a host batch (images, actions, z) to host
  outputs. A request's motion latent comes from its seed on the host
  (``np.random.default_rng(seed)``, the JAX package's draw), so its video
  depends only on its own (image, action, seed). The image-valued outputs
  are quantized to uint8 on the card, which quarters the readback.
  ``dispatch`` launches the whole generation from Python (PyTorch has no
  compiled program to enqueue) and starts the readback on a second stream
  (device.py::start_readback); ``fetch`` waits for that batch's copy alone.
- ``ArtifactEngine`` is the same engine over a loaded serving artifact: no
  model code, config or checkpoint on the serving host; its buckets are the
  artifact's batch sizes.
- ``MicroBatcher``: requests land in a queue; one dispatcher thread, which
  owns the device, takes up to the largest bucket of them (lingering
  ``max_wait_ms`` after the first so a lone request is not held), zero-pads
  them to the smallest bucket that fits, dispatches, and completes each
  request's future with its own rows. With ``pipeline=True`` it launches
  batch N before it waits for batch N-1's readback, so N's launches and
  kernels overlap N-1's copy and the completion of its futures; an idle
  queue drains the batch in flight at once. Outputs are the same either
  way.
- HTTP: stdlib ``ThreadingHTTPServer``. Handler threads decode and
  preprocess the PNG/JPEG and encode the response while the dispatcher
  launches kernels.

Endpoints:
    POST /v1/generate   JSON {"image": <base64 PNG/JPEG>, "action": int,
                              "seed": int?, "format": "npz"|"gif"}
                        -> npz (pred_im_seq/mask uint8, points f32, seed)
                           or an animated GIF of the predicted video
    GET  /healthz       liveness + model/bucket info
    GET  /stats         request/batch counters and latency percentiles

Input preprocessing is the evaluation pipeline's (short side to
image_size, center crop, [-1, 1]), byte-identical to the JAX package's.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..data import augment
from ..device import Readback, start_readback

if TYPE_CHECKING:
    from ..configs import Config

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def preprocess_image(pil_image, image_size: int, ops=None) -> np.ndarray:
    """The eval dataset's geometry: short side -> image_size by the reference
    center-crop box, then [-1, 1] float32. Returns [S, S, 3]."""
    ops = ops or augment.resolve_frame_ops("auto")
    frame = ops.prepare(pil_image.convert("RGB"))
    box, ratio = augment.center_crop_box(ops.size(frame), image_size)
    w, h = ops.size(frame)
    frame = ops.crop(ops.resize(frame, (int(w / ratio), int(h / ratio))), box)
    return ops.to_pm1(frame)


def request_z(seed: int, vae_dim: int) -> np.ndarray:
    """The request's motion latent: z ~ N(0, 1)^vae_dim keyed by its seed."""
    return np.random.default_rng(seed).standard_normal(vae_dim).astype(np.float32)


def to_uint8(x: np.ndarray, rescale: bool = True) -> np.ndarray:
    """[-1, 1] (or [0, 1] with rescale=False) -> uint8, truncating after *255."""
    if rescale:
        x = 0.5 * (x + 1.0)
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def device_quantize(x: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    """:func:`to_uint8` on the device: the same f32 arithmetic and the same
    truncating float -> uint8 cast."""
    x = x.float()
    if rescale:
        x = 0.5 * (x + 1.0)
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def encode_gif(frames_u8: np.ndarray, fps: int = 8) -> bytes:
    """[T, H, W, 3] uint8 -> animated GIF bytes."""
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames_u8]
    buf = io.BytesIO()
    ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return buf.getvalue()


def encode_npz(out: dict, seed: int) -> bytes:
    """One request's outputs -> the ``/v1/generate`` npz body (the JAX
    package's wire format: ``np.savez_compressed``)."""
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        pred_im_seq=out["pred_im_seq"],
        mask=out["mask"],
        current_points=out["current_points"].astype(np.float32),
        future_points=out["future_points"].astype(np.float32),
        seed=np.int64(seed),
    )
    return buf.getvalue()


def one_hot(actions: np.ndarray, n_action: int) -> np.ndarray:
    """[B] int -> [B, n_action] f32 one-hot."""
    actions = np.asarray(actions)
    act = np.zeros((actions.shape[0], n_action), np.float32)
    act[np.arange(actions.shape[0]), actions] = 1.0
    return act


def start_serve_readback(out: dict, copy_stream) -> Readback:
    """The engines' epilogue: the image-valued outputs quantized to uint8 on
    the device, the points in f32, and their readback started."""
    return start_readback({
        "pred_im_seq": device_quantize(out["pred_im_seq"]),
        "mask": device_quantize(out["mask"], rescale=False),
        "current_points": out["current_points"].float(),
        "future_points": out["future_points"].float(),
    }, copy_stream)


class InferenceEngine:
    """Owns the parameters and maps a host-side (images, actions, z) batch to
    host-side numpy outputs: pred_im_seq and mask as uint8, points as f32."""

    OUTPUT_KEYS = ("pred_im_seq", "mask", "current_points", "future_points")

    def __init__(self, config: Config, params: dict, device: str | torch.device = "cuda"):
        """params: from ``FinalGenerator.init_parameters``, ``bridge.from_jax``
        or ``checkpoint.load_parameters``."""
        from .final import FinalGenerator

        self.config = config
        self.final = FinalGenerator(config, device=device)
        self.final.load_parameters(params)
        self.device = self.final.device
        self.copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                            else None)
        self.vae_dim = config.model.vae_dim
        self.image_size = config.model.image_size
        self.n_action = config.model.n_action
        self.n_future_frames = config.model.n_future_frames

    def dispatch(self, images: np.ndarray, actions: np.ndarray, z: np.ndarray) -> Readback:
        """Launch the batch on the current stream and start its readback;
        returns without waiting for the device. Pair with :meth:`fetch`."""
        out = self.final.generate(images, one_hot(actions, self.n_action), z)
        return start_serve_readback(out, self.copy_stream)

    @staticmethod
    def fetch(out: Readback) -> dict:
        """Wait for a dispatched batch's readback; host numpy outputs."""
        return out.wait()

    def run(self, images: np.ndarray, actions: np.ndarray, z: np.ndarray) -> dict:
        """images [B, S, S, 3] f32 in [-1, 1]; actions [B] int; z [B, vae_dim]."""
        return self.fetch(self.dispatch(images, actions, z))


class ArtifactEngine:
    """InferenceEngine drop-in over a loaded serving artifact
    (eval/export.py::load_serving): the daemon runs from ONE file, with no
    model code, config or checkpoint on the serving host. Its buckets are
    the artifact's batch sizes (static shapes, one program each); the uint8
    epilogue and the readback are InferenceEngine's, so the wire format is
    the same. The programs run the same aten ops and kernels as the live
    engine."""

    OUTPUT_KEYS = InferenceEngine.OUTPUT_KEYS

    def __init__(self, artifact):
        meta = artifact.meta
        self.artifact = artifact
        self.device = artifact.device
        self.copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                            else None)
        self.vae_dim = int(meta["vae_dim"])
        self.image_size = int(meta["image_size"])
        self.n_action = int(meta["n_action"])
        self.n_future_frames = int(meta["n_future_frames"])
        self.n_data = 1  # each program is a one-device program
        self.buckets = tuple(artifact.batch_sizes)

    def dispatch(self, images: np.ndarray, actions: np.ndarray, z: np.ndarray) -> Readback:
        b = images.shape[0]
        if b not in self.buckets:
            raise ValueError(
                f"batch size {b} not in the artifact's exported buckets {list(self.buckets)}")
        out = self.artifact.generate(images, one_hot(actions, self.n_action), z)
        return start_serve_readback(out, self.copy_stream)

    fetch = staticmethod(InferenceEngine.fetch)

    def run(self, images: np.ndarray, actions: np.ndarray, z: np.ndarray) -> dict:
        return self.fetch(self.dispatch(images, actions, z))


@dataclass
class _Pending:
    image: np.ndarray
    action: int
    z: np.ndarray
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)


class MicroBatcher:
    """Request coalescing in front of an InferenceEngine (see the module
    docstring). Pad rows are zeros (image, one-hot, z), computed and
    discarded; inference-mode BN couples no rows, so padding changes only
    the batch shape."""

    def __init__(self, engine: InferenceEngine, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, max_queue: int = 256, pipeline: bool = True):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.engine = engine
        self.pipeline = pipeline
        self.buckets = tuple(sorted(set(buckets)))
        self.max_batch = self.buckets[-1]
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue[_Pending | None] = queue.Queue(maxsize=max_queue)
        self._stats_lock = threading.Lock()
        self.requests_total = 0
        self.rejected_total = 0
        self.batches_total = 0
        self.rows_total = 0  # sum of real (unpadded) rows over batches
        self.padded_rows_total = 0
        self._latencies_ms: deque[float] = deque(maxlen=1024)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="kpvid-batcher")
        self._stopped = False
        self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, image: np.ndarray, action: int, z: np.ndarray) -> Future:
        """Enqueue one request; returns a Future resolving to a dict of
        per-sample outputs. Raises queue.Full when overloaded (callers map
        it to HTTP 503)."""
        if self._stopped:
            raise RuntimeError("MicroBatcher is stopped")
        p = _Pending(image=image, action=int(action), z=z)
        try:
            self._q.put_nowait(p)
        except queue.Full:
            with self._stats_lock:
                self.rejected_total += 1
            raise
        with self._stats_lock:
            self.requests_total += 1
        return p.future

    def stop(self, timeout: float = 10.0):
        self._stopped = True
        self._q.put(None)
        self._thread.join(timeout=timeout)
        # a submit that passed the _stopped check may have enqueued behind
        # the sentinel; the loop has exited, so fail those futures now
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None and not p.future.done():
                p.future.set_exception(RuntimeError("MicroBatcher is stopped"))

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            n = len(lat)
            return {
                "requests_total": self.requests_total,
                "rejected_total": self.rejected_total,
                "batches_total": self.batches_total,
                "mean_batch_rows": (self.rows_total / self.batches_total
                                    if self.batches_total else 0.0),
                "pad_fraction": (
                    self.padded_rows_total / (self.rows_total + self.padded_rows_total)
                    if self.rows_total else 0.0
                ),
                "latency_ms_p50": lat[n // 2] if n else 0.0,
                "latency_ms_p95": lat[min(n - 1, int(n * 0.95))] if n else 0.0,
                "queue_depth": self._q.qsize(),
                "buckets": list(self.buckets),
            }

    # --------------------------------------------------------- dispatcher
    def warmup(self):
        """Run every bucket once before taking traffic, in the calling thread:
        the kernels are built (all sources at once) and cuDNN and cuBLAS make
        their first choices here. Raises if a kernel does not build or run."""
        if self.engine.device.type == "cuda":
            from ..ops import _build

            _build.build_all()
        s = self.engine.image_size
        for b in self.buckets:
            self.engine.run(
                np.zeros((b, s, s, 3), np.float32),
                np.zeros((b,), np.int64),
                np.zeros((b, self.engine.vae_dim), np.float32),
            )

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _collect(self) -> list[_Pending] | None:
        """Block for the first request, then linger max_wait for more.
        Returns None on the stop sentinel."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-arm the sentinel for the outer loop
                break
            batch.append(nxt)
        return batch

    def _loop(self):
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)  # CUDA's current device is per thread
        inflight: tuple[list[_Pending], Readback] | None = None
        while True:
            # idle queue: drain the batch in flight now, so its requesters
            # do not wait for the next arrival
            if inflight is not None and self._q.empty():
                self._finish(*inflight)
                inflight = None
            batch = self._collect()
            if batch is None:
                if inflight is not None:
                    self._finish(*inflight)
                return
            try:
                out = self._dispatch(batch)
            except Exception as exc:  # noqa: BLE001 - fail these requests, keep serving
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)
                continue
            # batch N is launched; reading back N-1 overlaps it
            if inflight is not None:
                self._finish(*inflight)
                inflight = None
            if self.pipeline:
                inflight = (batch, out)
            else:
                self._finish(batch, out)

    def _dispatch(self, batch: list[_Pending]) -> Readback:
        n = len(batch)
        b = self._bucket_for(n)
        s = self.engine.image_size
        images = np.zeros((b, s, s, 3), np.float32)
        actions = np.zeros((b,), np.int64)
        z = np.zeros((b, self.engine.vae_dim), np.float32)
        for i, p in enumerate(batch):
            images[i] = p.image
            actions[i] = p.action
            z[i] = p.z
        out = self.engine.dispatch(images, actions, z)
        # count only dispatched batches, so a raising dispatch does not skew
        # mean_batch_rows / pad_fraction
        with self._stats_lock:
            self.batches_total += 1
            self.rows_total += n
            self.padded_rows_total += b - n
        return out

    def _finish(self, batch: list[_Pending], dispatched: Readback):
        """Wait for a dispatched batch's readback and complete its futures.
        A failure fails exactly this batch's requests."""
        try:
            out = self.engine.fetch(dispatched)
        except Exception as exc:  # noqa: BLE001 - surfaced to the requesters
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        now = time.monotonic()
        with self._stats_lock:
            for p in batch:
                self._latencies_ms.append((now - p.enqueued_at) * 1000.0)
        for i, p in enumerate(batch):
            p.future.set_result({k: v[i] for k, v in out.items()})


# ---------------------------------------------------------------- HTTP


class _Handler(BaseHTTPRequestHandler):
    server_version = "kpvid-torch-serve/1.0"
    # set by make_server():
    batcher: MicroBatcher = None
    engine: InferenceEngine = None
    frame_ops = None
    request_timeout_s: float = 60.0
    quiet: bool = True

    def log_message(self, fmt, *args):  # the stdlib default writes every request to stderr
        if not self.quiet:
            super().log_message(fmt, *args)

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "image_size": self.engine.image_size,
                "n_action": self.engine.n_action,
                "n_future_frames": self.engine.n_future_frames,
                "buckets": list(self.batcher.buckets),
            })
        elif self.path == "/stats":
            self._send_json(200, self.batcher.stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/generate":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            req = self._parse_request()
        except ValueError as exc:
            self._send_json(400, {"error": str(exc)})
            return
        try:
            fut = self.batcher.submit(req["image"], req["action"], req["z"])
        except queue.Full:
            self._send_json(503, {"error": "server overloaded, retry"})
            return
        try:
            out = fut.result(timeout=self.request_timeout_s)
        except Exception as exc:  # noqa: BLE001 - engine errors become 500s
            self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._send_output(out, req)

    def _parse_request(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            raise ValueError("empty body")
        try:
            body = json.loads(self.rfile.read(length))
        except json.JSONDecodeError as exc:
            raise ValueError(f"invalid JSON: {exc}") from exc
        if "image" not in body or "action" not in body:
            raise ValueError("body must have 'image' (base64) and 'action' (int)")
        action = int(body["action"])
        if not 0 <= action < self.engine.n_action:
            raise ValueError(f"action must be in [0, {self.engine.n_action})")
        fmt = body.get("format", "npz")
        if fmt not in ("npz", "gif"):
            raise ValueError("format must be 'npz' or 'gif'")
        from PIL import Image, UnidentifiedImageError

        try:
            raw = base64.b64decode(body["image"], validate=True)
            pil = Image.open(io.BytesIO(raw))
            pil.load()
        except (ValueError, UnidentifiedImageError, OSError) as exc:
            raise ValueError(f"could not decode image: {exc}") from exc
        seed = int(body.get("seed", time.time_ns() & 0x7FFFFFFF))
        return {
            "image": preprocess_image(pil, self.engine.image_size, self.frame_ops),
            "action": action,
            "z": request_z(seed, self.engine.vae_dim),
            "seed": seed,
            "format": fmt,
        }

    def _send_output(self, out: dict, req: dict):
        # pred_im_seq and mask are uint8 from the engine
        if req["format"] == "gif":
            self._send_bytes(200, encode_gif(out["pred_im_seq"]), "image/gif",
                             extra={"X-Kpvid-Seed": str(req["seed"])})
            return
        self._send_bytes(200, encode_npz(out, req["seed"]), "application/x-npz",
                         extra={"X-Kpvid-Seed": str(req["seed"])})

    def _send_json(self, code: int, payload: dict):
        self._send_bytes(code, json.dumps(payload).encode(), "application/json")

    def _send_bytes(self, code: int, data: bytes, ctype: str, extra: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)


def make_server(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8000,
                buckets: tuple[int, ...] = DEFAULT_BUCKETS, max_wait_ms: float = 5.0,
                max_queue: int = 256, warmup: bool = False, quiet: bool = True,
                pipeline: bool = True) -> tuple[ThreadingHTTPServer, MicroBatcher]:
    """Wire a MicroBatcher and an HTTP server around an engine; ``warmup``
    runs every bucket before the port is bound. The caller owns
    serve_forever() (usually on a thread) and the shutdown order:
    server.shutdown(), then batcher.stop()."""
    batcher = MicroBatcher(engine, buckets=buckets, max_wait_ms=max_wait_ms,
                           max_queue=max_queue, pipeline=pipeline)
    if warmup:
        try:
            batcher.warmup()
        except BaseException:
            batcher.stop()
            raise
    handler = type("BoundHandler", (_Handler,), {
        "batcher": batcher,
        "engine": engine,
        "frame_ops": augment.resolve_frame_ops("auto"),
        "quiet": quiet,
    })
    server = ThreadingHTTPServer((host, port), handler)
    return server, batcher
