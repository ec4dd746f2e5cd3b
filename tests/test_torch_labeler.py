"""The port's pseudo-labeler and its data pipeline against kpvid_tpu's, on the CPU.

- ``pack_chunks`` and ``chunk_frames`` give the JAX package's slabs and
  segment tuples on seeded random streams (exact);
- ``make_synthetic_penn_tree`` writes the JAX package's bytes (exact);
- ``VideoFramesDataset`` frames are the JAX package's, uint8 and f32,
  through PIL and through the C++ kernels (exact);
- ``python -m kpvid_tpu_torch.make_pseudo_labels`` (its ``main``) on a tiny
  synthetic tree writes, per video, the keypoints of the JAX
  ``Stage1Generator.detect`` (the JAX labeler's fused upsample form) on that
  video's frames, with the same randomized stage-1 variables carried across
  by bridge.from_jax and a parameter file: atol 1e-5 at f32, 1e-4 at bf16
  (the current-points bound of tests/test_torch_final.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kpvid_tpu.data import VideoFramesDataset as JaxVideoFramesDataset
from kpvid_tpu.data import make_synthetic_penn_tree as jax_make_synthetic_penn_tree
from kpvid_tpu.data.keypoint import chunk_frames as jax_chunk_frames
from kpvid_tpu.data.keypoint import pack_chunks as jax_pack_chunks
from kpvid_tpu.models import Stage1Generator as JaxStage1Generator
from kpvid_tpu_torch import bridge, make_pseudo_labels
from kpvid_tpu_torch.checkpoint import save_parameters
from kpvid_tpu_torch.data import (
    VideoFramesDataset,
    chunk_frames,
    make_synthetic_penn_tree,
    pack_chunks,
    prefetch_videos,
)
from test_torch_final import randomize

SMOKE = dict(n_pts=4, heatmap_size=8, encoder_filters=8, translator_filters=16,
             pose_decoder_filters=16)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_penn_tree(tmp_path_factory.mktemp("penn_torch"), n_train=2, n_test=1)


def _stream(rng, lengths):
    return [(100 + i, n, rng.integers(0, 256, (n, 3, 2, 1), dtype=np.uint8))
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("chunk", [1, 4, 8, 13])
def test_pack_chunks_and_chunk_frames_match_jax(chunk):
    rng = np.random.default_rng(chunk)
    videos = _stream(rng, rng.integers(1, 20, 7))
    got = list(pack_chunks(iter(videos), chunk))
    want = list(jax_pack_chunks(iter(videos), chunk))
    assert len(got) == len(want) == -(-sum(n for _, n, _ in videos) // chunk)
    for (slab, segs), (jslab, jsegs) in zip(got, want):
        assert slab.dtype == jslab.dtype and segs == jsegs
        np.testing.assert_array_equal(slab, jslab)
    for _, _, frames in videos:
        got = list(chunk_frames(frames, chunk))
        want = list(jax_chunk_frames(frames, chunk))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_prefetch_videos_order_and_errors():
    videos = [(i, 2, np.full((2, 1), i, np.float32)) for i in range(5)]
    assert [v[0] for v in prefetch_videos(iter(videos), depth=2)] == [0, 1, 2, 3, 4]

    def failing():
        yield videos[0]
        raise RuntimeError("decode failed")

    it = prefetch_videos(failing(), depth=1)
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_synthetic_tree_matches_jax(tree, tmp_path):
    jax_tree = jax_make_synthetic_penn_tree(tmp_path / "jax", n_train=2, n_test=1)
    files = sorted(p.relative_to(tree) for p in Path(tree).rglob("*")
                   if p.is_file() and "pseudo_labels" not in p.parts)
    jax_files = sorted(p.relative_to(jax_tree) for p in Path(jax_tree).rglob("*") if p.is_file())
    assert files == jax_files and len(files) > 100
    for rel in files:
        assert (Path(tree) / rel).read_bytes() == (Path(jax_tree) / rel).read_bytes(), rel


@pytest.mark.parametrize("native_ops", ["off", "on"])
@pytest.mark.parametrize("as_uint8", [True, False])
def test_video_frames_match_jax(tree, as_uint8, native_ops):
    for subset in ("train", "test"):
        ds = VideoFramesDataset(str(tree), subset, 32, as_uint8=as_uint8, native_ops=native_ops)
        jds = JaxVideoFramesDataset(str(tree), subset, 32, as_uint8=as_uint8,
                                    native_ops=native_ops)
        assert ds.ops.native == (native_ops == "on")
        got, want = list(ds.iter_videos()), list(jds.iter_videos())
        assert [(v, n) for v, n, _ in got] == [(v, n) for v, n, _ in want]
        for (_, _, frames), (_, _, jframes) in zip(got, want):
            assert frames.dtype == jframes.dtype == (np.uint8 if as_uint8 else np.float32)
            np.testing.assert_array_equal(frames, jframes)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_labeler_matches_jax_detect(tree, tmp_path, dtype, atol):
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    gen = JaxStage1Generator(dtype=jdtype, upsample_mode="fused", **SMOKE)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.jit(lambda r: gen.init(r, dummy, dummy, train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng)}
    save_parameters(tmp_path / "stage1.npz", bridge.from_jax(v))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"paths: {{data_dir: '{tree}'}}\ntraining: {{compute_dtype: {dtype}}}\n"
                   "model: {n_pts: 4, image_size: 32, heatmap_size: 8, encoder_filters: 8, "
                   "translator_filters: 16, pose_decoder_filters: 16}\ndata: {labeler_chunk: 32}\n")
    stats = make_pseudo_labels.main(["--config", str(cfg), "--checkpoint",
                                     str(tmp_path / "stage1.npz"), "--device", "cpu"])
    detect = jax.jit(lambda v, im: gen.apply(v, im, method=gen.detect))
    n_frames = 0
    for subset in ("train", "test"):
        for vid, n, frames in JaxVideoFramesDataset(str(tree), subset, 32).iter_videos():
            got = np.load(Path(tree) / "pseudo_labels" / f"{vid:04d}.npy")
            assert got.shape == (n, 4, 2) and got.dtype == np.float32
            np.testing.assert_allclose(got, np.asarray(detect(v, frames)), rtol=0, atol=atol)
            n_frames += n
    assert stats["videos"] == 3 and stats["frames"] == n_frames
    assert stats["chunks"] == -(-n_frames // 32)


def test_labeler_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pseudo_labels.main(["--config", str(tmp_path / "none.yaml"),
                                 "--checkpoint", str(tmp_path / "none.npz")])
