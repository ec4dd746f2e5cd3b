"""The port's serving daemon against kpvid_tpu's, on the CPU.

Mirrors tests/test_server.py case for case on kpvid_tpu_torch's
InferenceEngine, MicroBatcher and make_server, at the smoke widths of that
file, f32, with the JAX variables (every BN statistic, BN affine and bias
drawn at random) carried across by bridge.from_jax. Tolerances:

- a request's output does not depend on its micro-batch beyond float
  reassociation: uint8 within one step (a value on a quantization
  boundary), points within 1e-5;
- the same bucket gives the same bits;
- the port's daemon against the JAX engine on the same image, action and
  seed: uint8 within one step, points within 1e-5 (the bounds of
  tests/test_torch_final.py::test_inference_engine_matches_jax);
- preprocessing and GIF encoding: byte-identical.
"""

import base64
import io
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from kpvid_tpu.configs import Config, ModelConfig, TrainingConfig
from kpvid_tpu.data.augment import resolve_frame_ops as jax_resolve_frame_ops
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator
from kpvid_tpu.eval.server import InferenceEngine as JaxInferenceEngine
from kpvid_tpu.eval.server import encode_gif as jax_encode_gif
from kpvid_tpu.eval.server import preprocess_image as jax_preprocess_image
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch.configs import Config as TConfig
from kpvid_tpu_torch.configs import ModelConfig as TModelConfig
from kpvid_tpu_torch.configs import TrainingConfig as TTrainingConfig
from kpvid_tpu_torch.data.augment import resolve_frame_ops
from kpvid_tpu_torch.eval import (
    InferenceEngine,
    MicroBatcher,
    encode_gif,
    make_server,
    preprocess_image,
    request_z,
)
from test_torch_final import SMOKE, randomize


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, the port's engine) on the same randomized weights."""
    cfg = Config(model=ModelConfig(**SMOKE),
                 training=TrainingConfig(batch_size=2, compute_dtype="float32")).validate()
    tcfg = TConfig(model=TModelConfig(**SMOKE), training=TTrainingConfig("float32")).validate()
    s1, s2 = JaxFinalGenerator(cfg).init_variables(jax.random.PRNGKey(0))
    rng = np.random.default_rng(17)
    s1 = {"params": randomize(s1["params"], rng), "batch_stats": randomize(s1["batch_stats"], rng)}
    s2p = randomize(s2["params"], rng)
    return JaxInferenceEngine(cfg, s1, s2p), InferenceEngine(
        tcfg, bridge.from_jax(s1, s2p), device="cpu")


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def _images(rng, n, s=32):
    return rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32)


def _png_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _u8_close(a, b, steps=1):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= steps, diff.max()


def test_microbatcher_coalesces_and_matches_single(engine, rng):
    """Concurrent requests ride one padded bucket; each sample's output
    matches running it alone."""
    images = _images(rng, 3)
    zs = [request_z(seed, engine.vae_dim) for seed in (1, 2, 3)]
    actions = [0, 2, 4]
    batcher = MicroBatcher(engine, buckets=(4,), max_wait_ms=400.0)
    try:
        futs = [batcher.submit(images[i], actions[i], zs[i]) for i in range(3)]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        batcher.stop()
    st = batcher.stats()
    assert st["batches_total"] == 1 and st["requests_total"] == 3
    assert st["pad_fraction"] == pytest.approx(0.25)
    for i in range(3):
        solo = engine.run(images[i : i + 1], np.asarray([actions[i]]), zs[i][None])
        assert outs[i]["pred_im_seq"].dtype == np.uint8
        _u8_close(outs[i]["pred_im_seq"], solo["pred_im_seq"][0])
        np.testing.assert_allclose(outs[i]["future_points"], solo["future_points"][0], atol=1e-5)


def test_seed_determinism_across_batches(engine, rng):
    """The same (image, action, seed) resubmitted later: the same bits."""
    image = _images(rng, 1)[0]
    z = request_z(7, engine.vae_dim)
    batcher = MicroBatcher(engine, buckets=(4,), max_wait_ms=1.0)
    try:
        a = batcher.submit(image, 1, z).result(timeout=120)
        b = batcher.submit(image, 1, z).result(timeout=120)
    finally:
        batcher.stop()
    for key in engine.OUTPUT_KEYS:
        np.testing.assert_array_equal(a[key], b[key])
    assert batcher.stats()["batches_total"] == 2


@pytest.mark.parametrize("mode", ["off", "on"])
def test_preprocess_image_matches_jax(rng, mode):
    """Byte-identical to the JAX package's, through PIL ('off') and through
    the C++ kernels ('on'), on landscape, portrait, square and palette
    inputs."""
    ops, jax_ops = resolve_frame_ops(mode), jax_resolve_frame_ops(mode)
    assert ops.native == (mode == "on")
    for h, w in ((96, 64), (64, 96), (48, 40), (33, 71), (32, 32)):
        pil = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for im in (pil, pil.convert("P")):
            got = preprocess_image(im, 32, ops)
            want = jax_preprocess_image(im, 32, jax_ops)
            assert got.shape == (32, 32, 3) and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_encode_gif_matches_jax(rng):
    frames = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    assert encode_gif(frames) == jax_encode_gif(frames)
    assert encode_gif(frames, fps=4) == jax_encode_gif(frames, fps=4)


class _Server:
    def __init__(self, engine, **kw):
        self.server, self.batcher = make_server(engine, port=0, **kw)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def post(self, body: dict):
        req = urllib.request.Request(f"{self.base}/v1/generate", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(f"{self.base}{path}", timeout=30) as r:
            return json.loads(r.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.stop()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_http_end_to_end(engine, rng):
    srv = _Server(engine, buckets=(1, 4), max_wait_ms=1.0)
    try:
        h = srv.get("/healthz")
        assert h["status"] == "ok" and h["image_size"] == 32 and h["buckets"] == [1, 4]
        img_b64 = _png_b64(rng.uniform(0, 255, (48, 40, 3)).astype(np.uint8))
        with srv.post({"image": img_b64, "action": 2, "seed": 5}) as r:
            assert r.headers["Content-Type"] == "application/x-npz"
            assert r.headers["X-Kpvid-Seed"] == "5"
            first = dict(np.load(io.BytesIO(r.read())))
        assert first["pred_im_seq"].shape == (6, 32, 32, 3)
        assert first["pred_im_seq"].dtype == np.uint8
        assert first["mask"].shape == (6, 32, 32, 1) and first["mask"].dtype == np.uint8
        assert first["current_points"].shape == (4, 2)
        assert first["future_points"].shape == (6, 4, 2)
        assert int(first["seed"]) == 5
        with srv.post({"image": img_b64, "action": 2, "seed": 5}) as r:
            again = dict(np.load(io.BytesIO(r.read())))
        for key in first:
            np.testing.assert_array_equal(first[key], again[key])

        with srv.post({"image": img_b64, "action": 0, "seed": 1, "format": "gif"}) as r:
            assert r.headers["Content-Type"] == "image/gif"
            gif = r.read()
        assert gif[:6] in (b"GIF87a", b"GIF89a")
        frames = Image.open(io.BytesIO(gif))
        assert frames.size == (32, 32)
        # PIL's GIF writer merges identical consecutive frames and extends
        # their duration, so count playback time, not frames
        total_ms = 0
        for i in range(frames.n_frames):
            frames.seek(i)
            total_ms += frames.info["duration"]
        assert total_ms == 6 * 125  # 6 frames at 8 fps

        for bad in (
            {"image": img_b64},  # missing action
            {"image": img_b64, "action": 99},  # out of range
            {"image": "!!notb64!!", "action": 0},  # undecodable
            {"image": img_b64, "action": 0, "format": "mp4"},  # bad format
        ):
            with pytest.raises(urllib.error.HTTPError) as e:
                srv.post(bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.base}/nope", timeout=30)
        assert e.value.code == 404

        st = srv.get("/stats")
        assert st["requests_total"] == 3 and st["batches_total"] >= 1
        assert st["latency_ms_p50"] > 0
    finally:
        srv.close()


class _GatedEngine:
    """The engine, with each dispatch held until ``gate`` is set."""

    def __init__(self, engine):
        self.engine = engine
        self.entered = threading.Event()
        self.gate = threading.Event()
        for name in ("device", "image_size", "n_action", "n_future_frames", "vae_dim"):
            setattr(self, name, getattr(engine, name))
        self.fetch = engine.fetch

    def dispatch(self, *args):
        self.entered.set()
        assert self.gate.wait(timeout=60)
        return self.engine.dispatch(*args)


def test_http_overload_is_503(engine, rng):
    """A full queue turns a request away with 503; the held requests then
    complete."""
    gated = _GatedEngine(engine)
    srv = _Server(gated, buckets=(1,), max_wait_ms=0.0, max_queue=1)
    image = _images(rng, 1)[0]
    z = request_z(0, engine.vae_dim)
    try:
        held = srv.batcher.submit(image, 0, z)
        assert gated.entered.wait(timeout=30)  # the dispatcher holds the first request
        queued = srv.batcher.submit(image, 1, z)  # fills the queue
        with pytest.raises(urllib.error.HTTPError) as e:
            srv.post({"image": _png_b64(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)),
                      "action": 0, "seed": 3})
        assert e.value.code == 503
        gated.gate.set()
        for fut in (held, queued):
            assert fut.result(timeout=60)["pred_im_seq"].shape == (6, 32, 32, 3)
        assert srv.get("/stats")["rejected_total"] == 1
    finally:
        gated.gate.set()
        srv.close()


def test_pipeline_matches_unpipelined(engine, rng):
    """The depth-1 pipeline only reorders host waits: a back-to-back stream
    gives the same bits with it on and off, and every future completes
    without further traffic."""
    n = 6
    images = _images(rng, n)
    zs = [request_z(100 + i, engine.vae_dim) for i in range(n)]
    actions = [i % 5 for i in range(n)]
    results = {}
    for pipelined in (False, True):
        batcher = MicroBatcher(engine, buckets=(2,), max_wait_ms=0.0, pipeline=pipelined)
        try:
            futs = [batcher.submit(images[i], actions[i], zs[i]) for i in range(n)]
            results[pipelined] = [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()
        assert batcher.stats()["batches_total"] >= 2
    for a, b in zip(results[False], results[True]):
        for key in engine.OUTPUT_KEYS:
            np.testing.assert_array_equal(a[key], b[key])


def test_pipeline_idle_drain_is_prompt(engine, rng):
    """With the pipeline on, a lone request is drained as soon as the queue
    goes idle: it never waits for a successor batch."""
    image = _images(rng, 1)[0]
    z = request_z(3, engine.vae_dim)
    batcher = MicroBatcher(engine, buckets=(1,), max_wait_ms=0.0, pipeline=True)
    try:
        batcher.warmup()
        t0 = time.monotonic()
        out = batcher.submit(image, 0, z).result(timeout=30)
        dt = time.monotonic() - t0
    finally:
        batcher.stop()
    assert out["pred_im_seq"].dtype == np.uint8
    assert dt < 20.0


def test_overload_rejects(engine, rng):
    """Queue bound -> queue.Full for callers (HTTP maps it to 503)."""
    image = _images(rng, 1)[0]
    z = request_z(0, engine.vae_dim)
    batcher = MicroBatcher(engine, buckets=(1,), max_wait_ms=0.0, max_queue=2)
    try:
        with pytest.raises(queue.Full):
            for _ in range(64):
                batcher.submit(image, 0, z)
    finally:
        batcher.stop()
    assert batcher.stats()["rejected_total"] >= 1


def test_daemon_npz_matches_jax_engine(engines, rng):
    """The port's daemon against the JAX InferenceEngine at f32 on the same
    PNG, action and seed: uint8 within one step, points within 1e-5."""
    jax_engine, engine = engines
    arr = rng.integers(0, 256, (60, 44, 3), dtype=np.uint8)
    srv = _Server(engine, buckets=(1, 2), max_wait_ms=1.0)
    try:
        with srv.post({"image": _png_b64(arr), "action": 3, "seed": 21}) as r:
            got = dict(np.load(io.BytesIO(r.read())))
    finally:
        srv.close()
    image = jax_preprocess_image(Image.fromarray(arr), 32, jax_resolve_frame_ops("auto"))
    want = jax_engine.run(image[None], np.asarray([3]), request_z(21, engine.vae_dim)[None])
    for key in ("pred_im_seq", "mask"):
        assert got[key].dtype == np.uint8 and got[key].shape == want[key].shape[1:]
        _u8_close(got[key], want[key][0])
    for key in ("current_points", "future_points"):
        np.testing.assert_allclose(got[key], want[key][0], rtol=0, atol=1e-5)


def test_serve_cli_merges_both_parameter_files(engine, tmp_path, rng):
    """serve's load_engine merges the stage-1 and stage-2 files by name into
    the engine the daemon serves; a file that matches nothing is refused;
    without a card the CLI raises."""
    from kpvid_tpu_torch import serve
    from kpvid_tpu_torch.checkpoint import save_parameters

    state = engine.final.model.state_dict()
    save_parameters(tmp_path / "s1.npz", {k: v for k, v in state.items() if k.startswith("stage1.")})
    save_parameters(tmp_path / "s2.npz", {k: v for k, v in state.items() if k.startswith("stage2.")})
    save_parameters(tmp_path / "other.npz", {"unrelated.weight": torch.zeros(2)})
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("training: {compute_dtype: float32}\nmodel: " + json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in SMOKE.items()}) + "\n")
    argv = ["--config", str(cfg), "--checkpoint_stage1", str(tmp_path / "s1.npz"),
            "--checkpoint_stage2", str(tmp_path / "s2.npz")]
    loaded = serve.load_engine(serve.build_parser().parse_args(argv + ["--device", "cpu"]))
    images = _images(rng, 2)
    z = np.stack([request_z(s, engine.vae_dim) for s in (4, 5)])
    want = engine.run(images, np.asarray([1, 2]), z)
    got = loaded.run(images, np.asarray([1, 2]), z)
    for key in engine.OUTPUT_KEYS:
        np.testing.assert_array_equal(got[key], want[key])
    bad = argv[:3] + [str(tmp_path / "other.npz")] + argv[4:] + ["--device", "cpu"]
    with pytest.raises(ValueError, match="matched 0"):
        serve.load_engine(serve.build_parser().parse_args(bad))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(argv)


@pytest.fixture(scope="module")
def artifacts(engines, tmp_path_factory):
    """(JAX ArtifactEngine, the port's ArtifactEngine, the port's artifact
    path), both exported at buckets 1 and 2 on the CPU from the engines'
    weights."""
    from kpvid_tpu.eval import ArtifactEngine as JaxArtifactEngine
    from kpvid_tpu.eval.export import export_serving as jax_export_serving
    from kpvid_tpu.eval.export import load_serving as jax_load_serving
    from kpvid_tpu_torch.eval import ArtifactEngine, export_serving, load_serving

    jax_engine, engine = engines
    root = tmp_path_factory.mktemp("artifacts")
    jax_export_serving(jax_engine.final, jax_engine.s1_vars, jax_engine.s2_params,
                       root / "jax.npz", batch_sizes=(1, 2), platforms=("cpu",))
    export_serving(engine.final, root / "torch.npz", batch_sizes=(1, 2))
    return (JaxArtifactEngine(jax_load_serving(root / "jax.npz")),
            ArtifactEngine(load_serving(root / "torch.npz", device="cpu")), root / "torch.npz")


def test_artifact_engine_matches_inference_engine(engine, artifacts, rng):
    """The daemon's engine over the artifact against the live engine on the
    same weights: uint8 within one step, points rtol 1e-5 / atol 1e-6."""
    art_engine = artifacts[1]
    assert art_engine.buckets == (1, 2) and art_engine.n_data == 1
    assert art_engine.image_size == 32 and art_engine.n_action == 5
    assert art_engine.n_future_frames == 6 and art_engine.vae_dim == 8
    images = _images(rng, 2)
    actions = np.asarray([1, 4])
    z = np.stack([request_z(s, engine.vae_dim) for s in (7, 8)])
    a = engine.run(images, actions, z)
    b = art_engine.run(images, actions, z)
    assert set(a) == set(b) == set(art_engine.OUTPUT_KEYS)
    for key in ("pred_im_seq", "mask"):
        assert b[key].dtype == np.uint8, key
        _u8_close(a[key], b[key])
    for key in ("current_points", "future_points"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="batch size 3"):
        art_engine.dispatch(_images(rng, 3), np.zeros(3, np.int64), np.zeros((3, 8), np.float32))


def test_artifact_engine_matches_jax_artifact_engine(artifacts, rng):
    """The port's ArtifactEngine against JAX's on the same weights, images,
    actions and seeds: uint8 within one step, points within 1e-5."""
    jax_art, art_engine, _ = artifacts
    assert art_engine.buckets == jax_art.buckets
    for b in art_engine.buckets:
        images = _images(rng, b)
        actions = np.arange(b) % 5
        z = np.stack([request_z(30 + s, 8) for s in range(b)])
        want = jax_art.run(images, actions, z)
        got = art_engine.run(images, actions, z)
        for key in ("pred_im_seq", "mask"):
            assert got[key].dtype == want[key].dtype == np.uint8
            _u8_close(got[key], want[key])
        for key in ("current_points", "future_points"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)


def test_http_serves_from_artifact(artifacts, rng):
    """The HTTP daemon runs from the artifact: /healthz reports its buckets
    and sizes; a generate round trip returns the npz contract."""
    art_engine = artifacts[1]
    srv = _Server(art_engine, buckets=art_engine.buckets, max_wait_ms=1.0)
    try:
        h = srv.get("/healthz")
        assert h == {"status": "ok", "image_size": 32, "n_action": 5, "n_future_frames": 6,
                     "buckets": [1, 2]}
        with srv.post({"image": _png_b64(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)),
                       "action": 2, "seed": 5}) as r:
            assert r.headers["X-Kpvid-Seed"] == "5"
            out = dict(np.load(io.BytesIO(r.read())))
    finally:
        srv.close()
    assert out["pred_im_seq"].shape == (6, 32, 32, 3) and out["pred_im_seq"].dtype == np.uint8
    assert out["mask"].shape == (6, 32, 32, 1) and out["mask"].dtype == np.uint8
    assert out["current_points"].shape == (4, 2) and out["future_points"].shape == (6, 4, 2)
    assert int(out["seed"]) == 5


def test_serve_cli_artifact_refusals(artifacts, tmp_path):
    """serve.main refuses --artifact with --config or a checkpoint, no source
    at all, and --buckets the artifact lacks, with the JAX CLI's messages;
    without a card it raises before reading the artifact."""
    from kpvid_tpu_torch import serve

    art = str(artifacts[2])
    for extra in (["--config", "cfg.yaml"], ["--checkpoint_stage1", "s1.npz"],
                  ["--checkpoint_stage2", "s2.npz"]):
        with pytest.raises(SystemExit, match="--artifact replaces --config"):
            serve.main(["--artifact", art, *extra])
    with pytest.raises(SystemExit, match=r"pass --config \+ --checkpoint_stage1"):
        serve.main(["--config", "cfg.yaml"])
    with pytest.raises(SystemExit, match=r"buckets \[3\] not exported in the artifact"):
        serve.main(["--artifact", art, "--buckets", "1", "3", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--artifact", art])
