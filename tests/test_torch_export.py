"""The port's serving artifact and its kernel ops, on the CPU.

kpvid_tpu_torch/eval/export.py against kpvid_tpu/eval/export.py, at the
smoke widths of tests/test_torch_final.py in f32, with every BN statistic,
BN affine and bias of the JAX variables drawn at random before they go
through the bridge. Tolerances:

- the artifact against JAX's generate on the same weights and z: the
  port-vs-JAX bounds of tests/test_torch_final.py (images, mask and crude
  atol 1e-4, keypoints atol 1e-5);
- the artifact against the port's live generate: rtol 1e-5, atol 1e-6, the
  bound of tests/test_export.py (on the CPU they agree bit for bit: the
  program runs the same aten ops and the same plain versions);
- the plain versions of the two backward kernels (the CPU implementations of
  their ops) against torch autograd through the plain forwards: within 1e-5
  of each gradient's largest magnitude.

``torch.library.opcheck`` holds each ``torch.ops.kpvid`` op's schema, fake
implementation and autograd registration against its CPU implementation.
"""

import collections
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.eval.export import export_serving as jax_export_serving
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.eval.export import export_serving, load_serving
from kpvid_tpu_torch.ops import keypoint_kernels
from kpvid_tpu_torch.ops.coords import heatmaps_to_keypoints, render_gaussian_maps
from test_torch_final import SMOKE, _setup

REPO = Path(__file__).resolve().parent.parent
BUCKETS = (1, 2)
# kernel nodes per program: #1 / #2 / #3 / #4, as the live path launches them
KERNEL_NODES = {"conv3x3_affine": 8, "up2_conv3_affine": 2, "pose_head": 1,
                "gaussian_render": 2}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX generator, its variables, the port's live generator, the
    artifact's path, the loaded artifact) on the same randomized weights."""
    cfg, tcfg, jgen, s1, s2p, params = _setup("float32")
    gen = FinalGenerator(tcfg, device="cpu")
    gen.load_parameters(params)
    path = tmp_path_factory.mktemp("artifact") / "serving.npz"
    meta = export_serving(gen, path, batch_sizes=BUCKETS)
    assert meta["batch_sizes"] == list(BUCKETS) and meta["device"] == "cpu"
    return jgen, s1, s2p, gen, path, load_serving(path, device="cpu")


def _inputs(b: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    im = rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
    z = rng.standard_normal((b, 8)).astype(np.float32)
    return im, act, z


def test_artifact_matches_jax(setup):
    jgen, s1, s2p, _, _, art = setup
    im, act, z = _inputs(2)
    want = jgen.jitted_generate(s1, s2p, im, act, None, z=z)
    got = art.generate(im, act, z)
    assert sorted(got) == sorted(want) == art.meta["outputs"]
    for key in want:
        atol = 1e-5 if "points" in key or key == "fut_pt_raw" else 1e-4
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("b", BUCKETS)
def test_artifact_matches_live_generate(setup, b):
    gen, art = setup[3], setup[5]
    im, act, z = _inputs(b, seed=20 + b)
    want = gen.generate(im, act, z)
    got = art.generate(im, act, z)
    assert set(got) == set(want)
    for key in want:
        assert got[key].device.type == "cpu" and got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_meta_outputs_match_jax(setup, tmp_path):
    jgen, s1, s2p, _, _, art = setup
    meta = jax_export_serving(jgen, s1, s2p, tmp_path / "jax.npz", batch_sizes=(1,),
                              platforms=("cpu",))
    assert art.meta["outputs"] == meta["outputs"]
    for key in ("image_size", "n_action", "vae_dim", "n_future_frames"):
        assert art.meta[key] == meta[key], key
    assert art.meta["torch_version"] == torch.__version__


def test_unknown_bucket_raises(setup):
    im, act, z = _inputs(3)
    with pytest.raises(ValueError, match="batch size 3"):
        setup[5].generate(im, act, z)


def test_unknown_format_version_is_refused(setup, tmp_path):
    with np.load(setup[4]) as data:
        arrays = dict(data)
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta["format_version"] = 99
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(tmp_path / "future.npz", **arrays)
    with pytest.raises(ValueError, match="unsupported artifact format 99"):
        load_serving(tmp_path / "future.npz", device="cpu")


@pytest.mark.parametrize("b", BUCKETS)
def test_graph_carries_the_kernels(setup, b):
    """Each program holds the kernels as torch.ops.kpvid nodes, 8 / 2 / 1 / 2,
    and none of their plain versions: the only torch conv over all B*T
    frames is the split first conv's, and no softmax or exp is left (the
    soft-argmax's and the render's plain forms)."""
    program = setup[5].programs[b]
    targets = collections.Counter(
        str(n.target) for n in program.graph.nodes if n.op == "call_function")
    kernels = {str(t).split(".")[1]: c for t, c in targets.items() if str(t).startswith("kpvid.")}
    assert kernels == KERNEL_NODES
    frames = b * SMOKE["n_future_frames"]
    convs = [n for n in program.graph.nodes
             if n.op == "call_function" and "conv" in str(n.target) and "kpvid" not in str(n.target)]
    assert convs
    assert sum(n.meta["val"].shape[0] == frames for n in convs) == 1
    assert not [t for t in targets if "softmax" in t or t.startswith("aten.exp")]


def test_loading_imports_no_model_code(setup):
    """A fresh process that loads and serves the artifact imports no
    kpvid_tpu_torch.models, .configs or .checkpoint, and no JAX."""
    code = f"""
import sys
import numpy as np
from kpvid_tpu_torch.eval.export import load_serving
from kpvid_tpu_torch.eval.server import ArtifactEngine
engine = ArtifactEngine(load_serving({str(setup[4])!r}, device="cpu"))
out = engine.run(np.zeros((2, 32, 32, 3), np.float32), np.array([0, 1]),
                 np.zeros((2, 8), np.float32))
assert out["pred_im_seq"].shape == (2, 6, 32, 32, 3), out["pred_im_seq"].shape
bad = sorted(m for m in sys.modules if m.startswith(("kpvid_tpu_torch.models",
             "kpvid_tpu_torch.configs", "kpvid_tpu_torch.checkpoint", "jax", "kpvid_tpu.")))
print("BAD", bad)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_export_cli_writes_the_artifact(setup, tmp_path, capsys):
    """python -m kpvid_tpu_torch.export_serving --device cpu: one .npz whose
    outputs are JAX's, serving what the live generator gives."""
    from kpvid_tpu_torch import export_serving as cli
    from kpvid_tpu_torch.checkpoint import save_parameters

    gen = setup[3]
    state = gen.model.state_dict()
    save_parameters(tmp_path / "s1.npz", {k: v for k, v in state.items() if k.startswith("stage1.")})
    save_parameters(tmp_path / "s2.npz", {k: v for k, v in state.items() if k.startswith("stage2.")})
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("training: {compute_dtype: float32}\nmodel: " + json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in SMOKE.items()}) + "\n")
    out = tmp_path / "cli.npz"
    report = cli.main(["--config", str(cfg), "--checkpoint_stage1", str(tmp_path / "s1.npz"),
                       "--checkpoint_stage2", str(tmp_path / "s2.npz"), "--out", str(out),
                       "--batch-sizes", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["bytes"] == out.stat().st_size and report["batch_sizes"] == [2]
    assert report["device"] == "cpu" and report["outputs"] == setup[5].meta["outputs"]
    im, act, z = _inputs(2, seed=5)
    got = load_serving(out, device="cpu").generate(im, act, z)
    want = gen.generate(im, act, z)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--config", str(cfg), "--checkpoint_stage1", str(tmp_path / "s1.npz"),
                      "--checkpoint_stage2", str(tmp_path / "s2.npz"), "--out", str(out)])


def _op_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 12, generator=g)
    k = torch.randn(3, 3, 12, 8, generator=g) / 10
    sc, sh = torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g) / 10
    raw = 3 * torch.randn(2, 9, 7, 4, generator=g)
    pts, p, q = keypoint_kernels.pose_head_train_plain(raw)
    mu = torch.rand(3, 4, 2, generator=g) * 2 - 1
    dmaps = torch.randn(3, 8, 6, 4, generator=g)
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "conv3x3_affine": [(x, k, sc, sh, True), (x.to(bf16), k.to(bf16), sc, sh, False)],
        "up2_conv3_affine": [(x, k, sc, sh, True), (x.to(bf16), k.to(bf16), sc, sh, False)],
        "pose_head": [(raw,), (raw.to(bf16),)],
        "pose_head_train": [(raw,), (raw.to(bf16),)],
        "pose_head_backward": [(torch.randn(2, 4, 2, generator=g), pts, p, q, f32),
                               (torch.randn(2, 4, 2, generator=g), pts, p, q, bf16)],
        "gaussian_render": [(mu, 8, 6, 14.3, f32, f32), (mu, 8, 6, 14.3, bf16, bf16)],
        "gaussian_render_backward": [(dmaps, mu, 14.3, f32), (dmaps.to(bf16), mu, 14.3, bf16)],
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_opcheck_on_cpu(name):
    op = getattr(torch.ops.kpvid, name).default
    for args in _op_cases()[name]:
        torch.library.opcheck(op, args)


def test_ops_cpu_implementations_are_the_plain_versions():
    cases = _op_cases()
    x, k, sc, sh, relu = cases["conv3x3_affine"][0]
    from kpvid_tpu_torch.ops import conv3x3_affine_plain, up2_conv3_affine_plain

    assert torch.equal(torch.ops.kpvid.conv3x3_affine(x, k, sc, sh, relu),
                       conv3x3_affine_plain(x, k, sc, sh, relu))
    assert torch.equal(torch.ops.kpvid.up2_conv3_affine(x, k, sc, sh, relu),
                       up2_conv3_affine_plain(x, k, sc, sh, relu))
    (raw,) = cases["pose_head"][0]
    points = torch.ops.kpvid.pose_head(raw)
    assert torch.equal(points, heatmaps_to_keypoints(raw))
    assert torch.equal(torch.ops.kpvid.pose_head_train(raw)[0], points)
    mu, h, w, inv_std, gd, od = cases["gaussian_render"][1]
    maps = torch.ops.kpvid.gaussian_render(mu, h, w, inv_std, gd, od)
    assert maps.is_contiguous()
    assert torch.equal(maps, render_gaussian_maps(mu, h, w, inv_std, gd, od))


def test_pose_head_backward_plain_matches_autograd():
    rng = np.random.default_rng(3)
    raw = torch.tensor(3 * rng.standard_normal((2, 12, 10, 5)), dtype=torch.float32,
                       requires_grad=True)
    ct = torch.tensor(rng.standard_normal((2, 5, 2)), dtype=torch.float32)
    (want,) = torch.autograd.grad(heatmaps_to_keypoints(raw), raw, ct)
    pts, p, q = keypoint_kernels.pose_head_train_plain(raw.detach())
    got = keypoint_kernels.pose_head_backward_plain(ct, pts, p, q, torch.float32)
    assert got.shape == raw.shape and got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("grid_dtype", [torch.float32, torch.bfloat16])
def test_render_backward_plain_matches_autograd(grid_dtype):
    rng = np.random.default_rng(4)
    mu = torch.tensor(rng.uniform(-1, 1, (3, 5, 2)), dtype=torch.float32, requires_grad=True)
    ct = torch.tensor(rng.standard_normal((3, 9, 7, 5)), dtype=torch.float32)
    (want,) = torch.autograd.grad(render_gaussian_maps(mu, 9, 7, 14.3, grid_dtype), mu, ct)
    got = keypoint_kernels.gaussian_render_backward_plain(ct, mu.detach(), 14.3, grid_dtype)
    assert got.shape == (3, 5, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_autograd_functions_take_the_registered_ops():
    """With a gradient on a CPU tensor the wrappers take the plain forward
    under autograd; the autograd Functions (the card's training path) run
    the registered ops, which on the CPU give the plain versions' values."""
    rng = np.random.default_rng(5)
    raw = torch.tensor(rng.standard_normal((2, 8, 8, 3)), dtype=torch.float32,
                       requires_grad=True)
    ct = torch.tensor(rng.standard_normal((2, 3, 2)), dtype=torch.float32)
    out = keypoint_kernels._PoseHead.apply(raw)
    assert torch.equal(out, heatmaps_to_keypoints(raw.detach()))
    (got,) = torch.autograd.grad(out, raw, ct)
    (want,) = torch.autograd.grad(keypoint_kernels.pose_head(raw), raw, ct)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    mu = torch.tensor(rng.uniform(-1, 1, (2, 3, 2)), dtype=torch.float32, requires_grad=True)
    ct = torch.tensor(rng.standard_normal((2, 8, 8, 3)), dtype=torch.float32)
    maps = keypoint_kernels._GaussianRender.apply(mu, 8, 8, 14.3, torch.float32, torch.float32)
    (got,) = torch.autograd.grad(maps, mu, ct)
    (want,) = torch.autograd.grad(keypoint_kernels.gaussian_render(mu, 8, 8), mu, ct)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_tracing_moves_no_counter():
    """Exporting runs the fake implementations, which launch and count
    nothing."""
    from kpvid_tpu_torch import ops

    class Net(torch.nn.Module):
        def forward(self, raw, mu):
            return ops.pose_head(raw), ops.gaussian_render(mu, 8, 8)

    ops.reset_launch_counts()
    program = torch.export.export(Net(), (torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 2)))
    assert sum(ops.launch_counts().values()) == 0
    assert {str(n.target) for n in program.graph.nodes if "kpvid" in str(n.target)} == {
        "kpvid.pose_head.default", "kpvid.gaussian_render.default"}


def test_graph_module_bytes_roundtrip(setup):
    """The bytes in the file are torch.export.save's: they load on their own."""
    with np.load(setup[4]) as data:
        blob = data["graph_b1"].tobytes()
    program = torch.export.load(io.BytesIO(blob))
    im, act, z = _inputs(1, seed=9)
    got = program.module()(*(torch.from_numpy(a) for a in (im, act, z)))
    want = setup[5].generate(im, act, z)
    for key in want:
        assert torch.equal(got[key], want[key]), key
