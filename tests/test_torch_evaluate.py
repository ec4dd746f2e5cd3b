"""The port's evaluate path against kpvid_tpu's, on the CPU.

- ``get_n_colors``, ``colorize_point_maps`` and ``render_point_images``
  against JAX's (f32 to 1e-5; bf16 within the bf16 render's known gap,
  ROADMAP section 3), with the colors as a host array or as a tensor on the
  maps' device (the same bytes);
- ``python -m kpvid_tpu_torch.evaluate``'s PNG tree against one composed
  from the JAX package: its ``SequenceDataset``/``HostDataPipeline`` batch,
  ``FinalGenerator.generate`` on the same explicit z and
  ``render_point_images``, written with the root ``evaluate.py``'s
  ``_save_img``/``_save_seq``. Smoke widths of tests/test_torch_final.py,
  BN statistics, BN affine and biases randomized;
- the same CLI against the root ``evaluate.py`` itself from one ``--seed``,
  each drawing its own latents (JAX's ``fold_in`` stream in both), on
  JAX's Orbax checkpoints and the parameter files exported from them;

The trainer-checkpoint hand-off to the daemon is in tests/test_torch_train.py.
"""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kpvid_tpu.data import HostDataPipeline as JaxPipe
from kpvid_tpu.data import SequenceDataset as JaxSeq
from kpvid_tpu.ops import colorize_point_maps as jax_colorize
from kpvid_tpu.utils import get_n_colors as jax_get_n_colors
from kpvid_tpu_torch import evaluate
from kpvid_tpu_torch.checkpoint import save_parameters
from kpvid_tpu_torch.data import make_synthetic_penn_tree, make_synthetic_pseudo_labels
from kpvid_tpu_torch.ops import colorize_point_maps
from kpvid_tpu_torch.utils import get_n_colors
from test_torch_final import SMOKE, _setup

REPO = Path(__file__).resolve().parent.parent
T = SMOKE["n_future_frames"]


setup = functools.lru_cache(maxsize=None)(_setup)  # one JAX init per dtype


def jax_evaluate_module():
    spec = importlib.util.spec_from_file_location("jax_evaluate_cli", REPO / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("penn")
    make_synthetic_penn_tree(root, n_train=1, n_test=3, frames_per_video=12)
    make_synthetic_pseudo_labels(root, n_pts=SMOKE["n_pts"])
    return root


def test_colors_match_jax():
    for n in (4, 40):
        assert get_n_colors(n).tobytes() == jax_get_n_colors(n).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colorize_point_maps_matches_jax(dtype):
    rng = np.random.default_rng(0)
    maps = rng.uniform(0, 1, (3, 16, 16, 40)).astype(np.float32)
    colors = get_n_colors(40)
    want = np.asarray(jax_colorize(jnp.asarray(maps, getattr(jnp, dtype)), colors), np.float32)
    got = colorize_point_maps(torch.from_numpy(maps).to(getattr(torch, dtype)), colors)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 16, 16, 3)
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 0.008)])
def test_render_point_images_matches_jax(dtype, atol):
    """The points' dtype picks the grid and the maps' dtype, as in JAX. f32: the
    exponentials differ in their last bits (1.3e-6 measured); bf16:
    within the bf16 render's gap (ROADMAP section 3: 0.0062 on the maps)."""
    cfg, tcfg, jgen, _, _, _ = setup("float32")
    from kpvid_tpu_torch.eval import FinalGenerator

    gen = FinalGenerator(tcfg, device="cpu")
    rng = np.random.default_rng(1)
    mu = rng.uniform(-1, 1, (5, SMOKE["n_pts"], 2)).astype(np.float32)
    colors = get_n_colors(SMOKE["n_pts"])
    jmu = jnp.asarray(mu, getattr(jnp, dtype))
    want = np.asarray(jax.jit(lambda m: jgen.render_point_images(m, colors))(jmu), np.float32)
    got = gen.render_point_images(torch.from_numpy(np.asarray(jmu.astype(jnp.float32)))
                                  .to(getattr(torch, dtype)), colors)
    assert got.dtype == getattr(torch, dtype) and got.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def _same_bytes(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colorize_point_maps_takes_colors_on_the_maps_device(dtype):
    """Colors given as a tensor on the maps' device, in f32 or already in the
    maps' dtype (as MeshReplica.constant holds them), tint the maps to the
    bytes the host colors give, which are JAX's."""
    rng = np.random.default_rng(2)
    maps = rng.uniform(0, 1, (3, 16, 16, 40)).astype(np.float32)
    colors = get_n_colors(40)
    tdt = getattr(torch, dtype)
    tmaps = torch.from_numpy(maps).to(tdt)
    want = colorize_point_maps(tmaps, colors)
    for tcolors in (torch.from_numpy(colors), torch.from_numpy(colors).to(tdt)):
        assert _same_bytes(colorize_point_maps(tmaps, tcolors), want)
    jax_want = np.asarray(jax_colorize(jnp.asarray(maps, getattr(jnp, dtype)), colors), np.float32)
    assert np.array_equal(want.float().numpy(), jax_want)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 0.008)])
def test_render_point_images_takes_colors_on_the_points_device(dtype, atol):
    """render_point_images with the colors as a tensor in the points' dtype
    on their device: the bytes of the host colors' images, and JAX's images
    within test_render_point_images_matches_jax's bounds."""
    cfg, tcfg, jgen, _, _, _ = setup("float32")
    from kpvid_tpu_torch.eval import FinalGenerator

    gen = FinalGenerator(tcfg, device="cpu")
    rng = np.random.default_rng(3)
    mu = rng.uniform(-1, 1, (5, SMOKE["n_pts"], 2)).astype(np.float32)
    colors = get_n_colors(SMOKE["n_pts"])
    jmu = jnp.asarray(mu, getattr(jnp, dtype))
    tmu = torch.from_numpy(np.asarray(jmu.astype(jnp.float32))).to(getattr(torch, dtype))
    got = gen.render_point_images(tmu, torch.from_numpy(colors).to(tmu.dtype))
    assert _same_bytes(got, gen.render_point_images(tmu, colors))
    want = np.asarray(jax.jit(lambda m: jgen.render_point_images(m, colors))(jmu), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def _write_config(path: Path, root: Path, dtype: str) -> Path:
    path.write_text(json.dumps({  # JSON is YAML
        "paths": {"data_dir": str(root)}, "training": {"compute_dtype": dtype},
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in SMOKE.items()},
        "data": {"num_workers": 2, "eval_batch_size": 2, "sequence_len": T + 1},
    }))
    return path


def _jax_tree(out_dir: Path, root: Path, dtype: str, seed: int):
    """The tree JAX's evaluate writes for the port's latents."""
    cfg, _, jgen, s1, s2p, _ = setup(dtype)
    cli = jax_evaluate_module()
    ds = JaxSeq(str(root), "test", n_pts=SMOKE["n_pts"], n_action=SMOKE["n_action"],
                sequence_len=T + 1, image_size=SMOKE["image_size"], with_image_seq=True)
    colors = get_n_colors(SMOKE["n_pts"])
    gen = jax.jit(lambda s1, s2, im, act, z: jgen.generate(s1, s2, im, act, None, z=z))
    render = jax.jit(lambda mu: jgen.render_point_images(mu, colors))
    idx = 0
    for b, batch in enumerate(JaxPipe(ds, 2, num_workers=2, seed=0, drop_remainder=False)
                              .batches()):
        bs = batch["image"].shape[0]
        z = evaluate.batch_z(seed, b, bs, SMOKE["vae_dim"])
        out = {k: np.asarray(v) for k, v in gen(s1, s2p, batch["image"], batch["action_code"],
                                                  z).items()}
        cur = np.asarray(render(out["current_points"]))
        fut = np.asarray(render(out["future_points"].reshape(-1, SMOKE["n_pts"], 2))).reshape(
            bs, T, 32, 32, 3)
        for i in range(bs):
            d = out_dir / f"{idx:04d}"
            d.mkdir(parents=True)
            cli._save_img(d / "input_im.png", out["im"][i], True)
            cli._save_img(d / "current_points.png", cur[i], False)
            cli._save_seq(d / "real_seq", batch["real_im_seq"][i], True)
            cli._save_seq(d / "pred_seq", out["pred_im_seq"][i], True)
            cli._save_seq(d / "mask", out["mask"][i], False)
            cli._save_seq(d / "crude", out["pred_im_crude"][i], True)
            cli._save_seq(d / "pred_points", fut[i], False)
            idx += 1


def _files(root: Path) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*.png"))}


def _pixels(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)), np.int16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_png_tree_matches_jax(tree, tmp_path, dtype):
    """3 test videos at eval batch 2 (a ragged last batch): the same files,
    each sample 2 PNGs and 5 directories of T PNGs. f32: byte for byte.
    bf16: every pixel within the stated uint8 steps of JAX's (JAX writes
    its bf16 arrays through bf16 arithmetic, the port through f32)."""
    _, _, _, _, _, params = setup(dtype)
    s1 = save_parameters(tmp_path / "s1.npz", {k: v for k, v in params.items()
                                               if k.startswith("stage1.")})
    s2 = save_parameters(tmp_path / "s2.npz", {k: v for k, v in params.items()
                                               if k.startswith("stage2.")})
    cfg = _write_config(tmp_path / "cfg.yaml", tree, dtype)
    stats = evaluate.main(["--config", str(cfg), "--checkpoint_stage1", str(s1),
                           "--checkpoint_stage2", str(s2), "--save_dir", str(tmp_path / "port"),
                           "--seed", "3", "--device", "cpu", "--png-workers", "3"])
    assert stats["samples"] == 3 and stats["batches"] == 2
    _jax_tree(tmp_path / "jax", tree, dtype, seed=3)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 3 * (2 + 5 * T)
    if dtype == "float32":
        differ = [k for k in want if got[k] != want[k]]
        assert not differ, differ[:5]
    else:
        worst = max(int(np.abs(_pixels(got[k]) - _pixels(want[k])).max()) for k in want)
        assert worst <= BF16_UINT8_STEPS, worst


BF16_UINT8_STEPS = 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_cli_from_the_seed_matches_jaxs(tree, tmp_path, dtype, monkeypatch):
    """``python -m kpvid_tpu_torch.evaluate --seed 3`` against the root
    ``evaluate.py --seed 3`` on one pair of checkpoints, each CLI drawing its
    own latents (nothing handed over): JAX's Orbax checkpoints of the
    randomized smoke trees, and the port's parameter files that
    ``tools/export_torch_params.py`` writes from them. f32: the PNG tree
    byte for byte; bf16: within test_evaluate_png_tree_matches_jax's bound."""
    import sys

    from kpvid_tpu.utils.checkpoint import save_checkpoint

    _, _, _, s1, s2p, _ = setup(dtype)
    save_checkpoint(tmp_path / "jax", "stage1", 1, {"g_params": s1["params"],
                                                    "batch_stats": s1["batch_stats"]})
    save_checkpoint(tmp_path / "jax", "stage2", 1, {"g_params": s2p})
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import export_torch_params
    finally:
        sys.path.remove(str(REPO / "tools"))
    npz = {s: export_torch_params.main(["--checkpoint", str(tmp_path / "jax" / s),
                                        "--output", str(tmp_path / f"{s}.npz")])
           for s in ("stage1", "stage2")}
    cfg = _write_config(tmp_path / "cfg.yaml", tree, dtype)
    evaluate.main(["--config", str(cfg), "--checkpoint_stage1", str(npz["stage1"]),
                   "--checkpoint_stage2", str(npz["stage2"]), "--save_dir", str(tmp_path / "port"),
                   "--seed", "3", "--device", "cpu", "--png-workers", "3"])
    monkeypatch.setattr(sys, "argv", [
        "evaluate.py", "--config", str(cfg), "--checkpoint_stage1", str(tmp_path / "jax" / "stage1"),
        "--checkpoint_stage2", str(tmp_path / "jax" / "stage2"), "--save_dir",
        str(tmp_path / "jax_tree"), "--seed", "3", "--png-workers", "3"])
    jax_evaluate_module().main()
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax_tree")
    assert sorted(got) == sorted(want) and len(got) == 3 * (2 + 5 * T)
    if dtype == "float32":
        differ = [k for k in want if got[k] != want[k]]
        assert not differ, differ[:5]
    else:
        worst = max(int(np.abs(_pixels(got[k]) - _pixels(want[k])).max()) for k in want)
        assert worst <= BF16_UINT8_STEPS, worst


def test_evaluate_defaults_to_the_card(tree, tmp_path):
    cfg = _write_config(tmp_path / "cfg.yaml", tree, "float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--config", str(cfg), "--checkpoint_stage1", "x",
                       "--checkpoint_stage2", "y"])
