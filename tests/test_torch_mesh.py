"""One process over several devices (``--mesh``) in the port against kpvid_tpu's, on the CPU.

The mesh is a device list (eval/final.py::GeneratorMesh, the counterpart of
``make_mesh(devices=...)``), here ``["cpu", "cpu"]``: the parameters
replicated, a batch's rows split evenly, replica ``i`` on rows
``[i * n, (i + 1) * n)``. At the smoke widths of tests/test_torch_final.py
in f32, with every BN statistic, BN affine and bias of the JAX variables
drawn at random:

- generate over the mesh against JAX's ``generate`` on a 2-device 'data'
  mesh (params replicated, batch sharded): tests/test_parallel.py::
  test_serving_generate_dp's bounds, rtol 1e-4 / atol 1e-5; and each
  replica's rows the bits of one FinalGenerator run on those rows alone;
- the mesh engine against JAX's mesh engine (uint8 within one step, points
  atol 1e-5), and its MicroBatcher's buckets rounded up to multiples of the
  replica count (tests/test_server.py::test_mesh_engine_matches_single_device);
- ``serve --mesh --artifact`` and ``evaluate --mesh`` under several
  processes refused with JAX's messages; ``evaluate --mesh`` over two
  replicas writes the one-replica tree (pixels within one uint8 step), and
  its launch copies the colors to each replica once per dtype;
- ``python -m kpvid_tpu_torch.bench --device cpu --batch 2`` (at the smoke
  widths: the test swaps its ``Config()``) prints one JSON line without
  ``vs_baseline``, with and without ``--mesh``; its inputs are the root
  ``bench.py``'s draws.
"""

import copy
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.eval.server import InferenceEngine as JaxInferenceEngine
from kpvid_tpu.parallel import batch_sharding, make_mesh, replicate
from kpvid_tpu_torch import bench, configs, evaluate, parallel, serve
from kpvid_tpu_torch.checkpoint import save_parameters
from kpvid_tpu_torch.data import make_synthetic_penn_tree, make_synthetic_pseudo_labels
from kpvid_tpu_torch.eval import InferenceEngine, MicroBatcher, request_z
from kpvid_tpu_torch.eval import final as final_mod
from kpvid_tpu_torch.eval.final import FinalGenerator, GeneratorMesh
from kpvid_tpu_torch.utils import get_n_colors
from test_torch_final import SMOKE, _setup

CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def setup():
    return _setup("float32")


def inputs(b: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    im = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
    z = rng.standard_normal((b, 8)).astype(np.float32)
    return im, act, z


def test_mesh_generate_matches_jax_data_mesh(setup):
    """4 rows over 2 replicas against JAX's generate with the batch sharded
    over a 2-device 'data' mesh; each replica's rows are one generator's
    bits on those rows alone."""
    cfg, tcfg, jgen, s1, s2p, params = setup
    im, act, z = inputs(4)
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    sh = batch_sharding(mesh)
    want = jax.jit(lambda a, b, c, d, e: jgen.generate(a, b, c, d, None, z=e))(
        replicate(mesh, s1), replicate(mesh, s2p), jax.device_put(im, sh),
        jax.device_put(act, sh), jax.device_put(z, sh))
    gm = GeneratorMesh(tcfg, params, CPU2)
    assert gm.n_data == 2 and [r.stream for r in gm.replicas] == [None, None]
    parts = gm.map(lambda rep, *rows: rep.final.generate(*rows), im, act, z)
    one = FinalGenerator(tcfg, device="cpu")
    one.load_parameters(params)
    for key in ("current_points", "future_points", "pred_im_seq", "mask", "pred_im_crude"):
        got = torch.cat([p[key] for p in parts]).numpy()
        assert got.shape == tuple(want[key].shape), key
        np.testing.assert_allclose(got, np.asarray(want[key]), rtol=1e-4, atol=1e-5, err_msg=key)
        for i, p in enumerate(parts):
            alone = one.generate(im[2 * i:2 * i + 2], act[2 * i:2 * i + 2], z[2 * i:2 * i + 2])
            assert torch.equal(p[key], alone[key]), (key, i)
    with pytest.raises(ValueError, match="3 rows does not split over 2 replicas"):
        gm.map(lambda rep, *rows: None, im[:3])


def test_mesh_run_joins_the_replicas_rows(setup):
    """GeneratorMesh.run: each replica's tensors read back as f32 numpy and
    joined in row order; a batch that does not split runs whole on the
    first replica."""
    _, tcfg, _, _, _, params = setup
    gm = GeneratorMesh(tcfg, params, ["cpu"] * 3)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    seen = []

    def fn(rep, rows):
        seen.append((gm.replicas.index(rep), rows.shape[0]))
        return {"x": torch.from_numpy(rows).double() * 2,
                "n": torch.full((rows.shape[0],), len(seen))}

    out = gm.run(fn, x)
    assert seen == [(0, 2), (1, 2), (2, 2)]
    assert out["x"].dtype == np.float32 and np.array_equal(out["x"], 2 * x)
    assert np.array_equal(out["n"], [1, 1, 2, 2, 3, 3])
    seen.clear()
    ragged = gm.run(fn, x[:4])
    assert seen == [(0, 4)] and np.array_equal(ragged["x"], 2 * x[:4])


def test_mesh_engine_matches_jax_mesh_engine(setup):
    """InferenceEngine over ["cpu", "cpu"] against JAX's InferenceEngine on
    a 2-device 'data' mesh: uint8 within one step, points atol 1e-5; the
    readbacks joined in row order."""
    cfg, tcfg, _, s1, s2p, params = setup
    rng = np.random.default_rng(12)
    images = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    actions = np.array([0, 2, 4, 1])
    z = np.stack([request_z(s, 8) for s in (101, 102, 103, 104)])
    want = JaxInferenceEngine(cfg, s1, s2p,
                              mesh=make_mesh(n_data=2, devices=jax.devices()[:2])).run(
        images, actions, z)
    engine = InferenceEngine(tcfg, params, device="cpu", devices=CPU2)
    assert engine.n_data == 2 and engine.device == torch.device("cpu")
    got = engine.run(images, actions, z)
    assert set(got) == set(want) == set(engine.OUTPUT_KEYS)
    for key in ("pred_im_seq", "mask"):
        assert got[key].dtype == np.uint8 and got[key].shape == want[key].shape
        assert np.abs(got[key].astype(np.int16) - want[key].astype(np.int16)).max() <= 1, key
    for key in ("current_points", "future_points"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
    single = InferenceEngine(tcfg, params, device="cpu")
    assert single.n_data == 1
    for i in range(2):  # replica i's rows: one engine's bits on those rows
        alone = single.run(images[2 * i:2 * i + 2], actions[2 * i:2 * i + 2], z[2 * i:2 * i + 2])
        assert all(np.array_equal(alone[k], got[k][2 * i:2 * i + 2]) for k in alone)


def test_micro_batcher_rounds_buckets_to_the_replicas(setup):
    """Three replicas: buckets (2, 4) become (3, 6); three requests go as one
    batch, each within one uint8 step (points 1e-5) of the request alone."""
    _, tcfg, _, _, _, params = setup
    engine = InferenceEngine(tcfg, params, device="cpu", devices=["cpu"] * 3)
    single = InferenceEngine(tcfg, params, device="cpu")
    assert MicroBatcher(single, buckets=(2, 4)).buckets == (2, 4)
    batcher = MicroBatcher(engine, buckets=(2, 4), max_wait_ms=400.0)
    try:
        assert batcher.buckets == (3, 6) and batcher.max_batch == 6
        images, _, _ = inputs(3, seed=5)
        zs = [request_z(seed, 8) for seed in (1, 2, 3)]
        futs = [batcher.submit(images[i], a, zs[i]) for i, a in enumerate((0, 2, 4))]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        batcher.stop()
    assert batcher.stats()["batches_total"] == 1
    for i, a in enumerate((0, 2, 4)):
        solo = single.run(images[i:i + 1], np.asarray([a]), zs[i][None])
        diff = np.abs(outs[i]["pred_im_seq"].astype(np.int16)
                      - solo["pred_im_seq"][0].astype(np.int16))
        assert diff.max() <= 1
        np.testing.assert_allclose(outs[i]["future_points"], solo["future_points"][0], atol=1e-5)


def test_serve_mesh_refuses_an_artifact():
    """JAX's serve.py:92 message."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--artifact", "serving.npz", "--mesh", "--device", "cpu"])
    assert str(e.value) == ("--mesh does not apply to --artifact (artifact graphs are "
                            "single-device programs)")


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory, setup):
    root = tmp_path_factory.mktemp("mesh_eval")
    params = setup[5]
    save_parameters(root / "params.npz", params)
    make_synthetic_penn_tree(root / "penn", n_train=1, n_test=3, frames_per_video=12)
    make_synthetic_pseudo_labels(root / "penn", n_pts=SMOKE["n_pts"])
    (root / "eval.yaml").write_text(json.dumps({
        "paths": {"data_dir": str(root / "penn")}, "training": {"compute_dtype": "float32"},
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in SMOKE.items()},
        "data": {"num_workers": 1, "eval_batch_size": 2,
                 "sequence_len": SMOKE["n_future_frames"] + 1}}))

    def args(save_dir, *extra):
        return ["--config", str(root / "eval.yaml"), "--checkpoint_stage1",
                str(root / "params.npz"), "--checkpoint_stage2", str(root / "params.npz"),
                "--save_dir", str(save_dir), "--seed", "5", "--device", "cpu",
                "--png-workers", "2", *extra]

    return root, args


def test_evaluate_mesh_refuses_several_processes(eval_tree, monkeypatch):
    """JAX's evaluate.py:133-140 message, before anything is read."""
    root, args = eval_tree
    monkeypatch.setattr(parallel, "maybe_initialize", lambda device: True)
    with pytest.raises(ValueError) as e:
        evaluate.main(args(root / "never", "--mesh"))
    assert str(e.value) == ("--mesh shards one batch over a global mesh; under multi-process "
                            "execution use the per-host batch sharding instead (drop --mesh)")
    assert not (root / "never").exists()


def test_evaluate_mesh_writes_the_one_replica_tree(eval_tree, monkeypatch):
    """3 test videos at batch 2 over two replicas (the ragged last batch of
    one row on the first): the same PNG files as without --mesh, each pixel
    within one uint8 step; with the default device list (one CPU) the same
    bytes."""
    from PIL import Image

    root, args = eval_tree
    plain = evaluate.main(args(root / "plain"))
    one = evaluate.main(args(root / "mesh1", "--mesh"))
    monkeypatch.setattr(final_mod, "mesh_devices", lambda device: [torch.device("cpu")] * 2)
    two = evaluate.main(args(root / "mesh2", "--mesh"))
    assert plain["batches"] == one["batches"] == two["batches"] == 2
    assert plain["samples"] == two["samples"] == 3

    def files(d):
        return {p.relative_to(d).as_posix(): p for p in sorted(d.rglob("*.png"))}

    want = files(root / "plain")
    assert len(want) == 3 * (2 + 5 * SMOKE["n_future_frames"])
    got1, got2 = files(root / "mesh1"), files(root / "mesh2")
    assert sorted(got1) == sorted(got2) == sorted(want)
    assert all(got1[k].read_bytes() == want[k].read_bytes() for k in want)
    worst = max(int(np.abs(np.asarray(Image.open(got2[k]), np.int16)
                           - np.asarray(Image.open(want[k]), np.int16)).max()) for k in want)
    assert worst <= 1


def test_evaluate_launch_copies_the_colors_once_per_replica(setup):
    """evaluate's launch (generate and both point images) over two replicas
    in bf16 copies the colors to each replica once per dtype (f32 for the
    detected points, bf16 for the decoded ones) and reuses the same tensors
    for the next batch; its point images are the bytes of
    ``render_point_images`` with the host colors."""
    _, tcfg, _, _, _, params = setup
    cfg = copy.deepcopy(tcfg)
    cfg.training.compute_dtype = "bfloat16"
    colors = get_n_colors(SMOKE["n_pts"])
    gm = GeneratorMesh(cfg, params, CPU2)
    launch = evaluate.make_launch(colors)
    rows = inputs(4)
    first = gm.map(launch, *rows)
    held = [dict(rep.constants) for rep in gm.replicas]
    second = gm.map(launch, *rows)
    for rep, before, out, again in zip(gm.replicas, held, first, second):
        assert set(rep.constants) == {("colors", torch.float32), ("colors", torch.bfloat16)}
        assert all(rep.constants[k] is v for k, v in before.items())
        assert out["future_points"].dtype == torch.bfloat16
        fut = out["future_points"].reshape(-1, SMOKE["n_pts"], 2)
        for key, want in (("current_points_im", rep.final.render_point_images(
                out["current_points"], colors)),
                ("future_points_im", rep.final.render_point_images(fut, colors))):
            for got in (out[key], again[key]):
                assert got.dtype == want.dtype
                assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), key
    assert held[0][("colors", torch.float32)] is not held[1][("colors", torch.float32)]


@pytest.mark.parametrize("mesh", [False, True], ids=["single", "mesh"])
def test_bench_prints_one_json_line(setup, capsys, monkeypatch, mesh):
    """``python -m kpvid_tpu_torch.bench --device cpu --batch 2`` at the
    smoke widths: one JSON line, bench.py's metric without vs_baseline; with
    --mesh over two replicas a batch of 3 rounds down to 2."""
    tcfg = setup[1]
    monkeypatch.setattr(configs, "Config", lambda: tcfg)
    monkeypatch.setattr(final_mod, "mesh_devices", lambda device: [torch.device("cpu")] * 2)
    argv = ["--device", "cpu", "--batch", "3" if mesh else "2"] + (["--mesh"] if mesh else [])
    with mock.patch.multiple(bench, WARMUP=1, ROUNDS=1, ITERS=2):
        rec = bench.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert set(printed) == {"metric", "value", "unit"}
    assert printed["metric"] == "generated_frames_per_sec_per_chip"
    assert printed["unit"] == "frames/s" and printed["value"] > 0
    assert rec["batch"] == 2 and rec["n_data"] == (2 if mesh else 1)
    assert printed["value"] == round(2 * SMOKE["n_future_frames"] * 2 / rec["best_round_s"], 1)


def test_bench_inputs_are_jax_bench_pys():
    """bench's images, actions and latents at ``Config()``, batch 2, are the
    root bench.py's draws: ``uniform(PRNGKey(2), -1, 1)`` images bit for
    bit, class-0 one-hots, and generate's ``normal(key, (B, vae_dim))`` of
    ``PRNGKey(100 + i)`` for the warm-up calls and ``PRNGKey(8 r + i)`` for
    the timed ones within 4 ulp (the port's erfinv takes numpy's log1p)."""
    import sys
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = configs.Config().validate()
    m = cfg.model
    im, act, zs = bench.inputs(cfg, 2)
    want = jax.random.uniform(jax.random.PRNGKey(2), (2, m.image_size, m.image_size, 3),
                              jnp.float32, -1.0, 1.0)
    assert im.tobytes() == np.asarray(want).tobytes()
    assert np.array_equal(act, np.asarray(jax.nn.one_hot(jnp.zeros((2,), jnp.int32), m.n_action)))
    seeds = [100 + i for i in range(bench.WARMUP)] + [
        r * bench.ITERS + i for r in range(bench.ROUNDS) for i in range(bench.ITERS)]
    assert len(zs) == len(seeds)
    for z, seed in zip(zs, seeds):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (2, m.vae_dim), jnp.float32))
        assert int(chip_smoke.ulps(z, want).max()) <= 4, seed


def test_mesh_devices_default():
    """The CPU mesh is the CPU once; a card's mesh raises without a card."""
    assert final_mod.mesh_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            final_mod.mesh_devices("cuda")
