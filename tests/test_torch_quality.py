"""``chip_smoke.py --quality``'s plumbing on the CPU, and the port's own
copies of the production configs.

The chain (stage 1 on the synthetic tree, the labeler, stage 2 on its
labels, evaluate) runs here as the card runs it, four CLIs in processes of
their own, at smoke widths for two steps a stage with a sweep after every
step, and with a VGG19 of 16 channels; the card runs it at ``Config()``
for 2,250 and 2,000 steps. The bounds are checked on made-up curves.
"""

import dataclasses
import filecmp
import sys
from pathlib import Path

import numpy as np
import pytest

from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.losses import synthesize_vgg19_params

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SMOKE = REPO / "kpvid_tpu_torch" / "configs" / "smoke.yaml"


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", ["penn.yaml", "penn_synth.yaml"])
def test_production_config_copies_read_as_jax_reads_them(name):
    """Each copy is JAX's file byte for byte, and the port's loader reads it
    to the values kpvid_tpu's load_config reads from JAX's, field by field
    (every field the port has, the learning-rate schedule's included)."""
    mine = REPO / "kpvid_tpu_torch" / "configs" / name
    theirs = REPO / "kpvid_tpu" / "configs" / name
    assert filecmp.cmp(mine, theirs, shallow=False)
    got, want = tcfgs.load_config(mine), jax_load_config(theirs)
    n = 0
    for section in ("paths", "training", "model", "data", "parallel"):
        g, w = getattr(got, section), getattr(want, section)
        for field, val in _fields(g).items():
            ref = getattr(w, field)
            if dataclasses.is_dataclass(val):
                assert _fields(val) == {f: getattr(ref, f) for f in _fields(val)}, field
            else:
                assert val == ref, (section, field, val, ref)
            n += 1
    assert n > 40


def test_quality_config_sets_the_sweep_and_the_paths(tmp_path):
    """The run's YAML is the source's with its paths under the run's root
    and test_interval changed; every other value stays."""
    src = REPO / chip_smoke.QUALITY_CONFIG
    conf = chip_smoke.quality_config(src, tmp_path, 250)
    got, want = tcfgs.load_config(conf), tcfgs.load_config(src)
    assert want.training.test_interval == 500 and got.training.test_interval == 250
    assert got.paths.data_dir == str(tmp_path / "penn")
    assert got.paths.log_dir == str(tmp_path / "log")
    assert not Path(got.paths.vggnet).exists()
    assert got.model == want.model and got.data == want.data
    assert (dataclasses.replace(got.training, test_interval=500) == want.training)


def test_quality_chain_runs_at_smoke_widths(tmp_path):
    """The four CLIs in subprocesses, two steps a stage, a sweep every step:
    stage 1's PSNR and reconstruction and stage 2's KL and reconstruction at
    steps 0, 1 and 2 (a sweep at step N takes --max-steps N + 1), the
    checkpoints the labeler and evaluate read, and evaluate's whole tree."""
    vgg = tmp_path / "vgg19.npy"
    np.save(vgg, {n: [p["kernel"], p["bias"]]
                  for n, p in synthesize_vgg19_params(max_width=16).items()}, allow_pickle=True)
    root = tmp_path / "run"
    root.mkdir()
    chain = chip_smoke.quality_chain(root / "quality.yaml", root, 2, 2, "cpu")
    assert [name for name, _ in chain] == ["stage 1", "label", "stage 2", "evaluate"]
    assert chain[0][1][-4:] == ["--max-steps", "3", "--device", "cpu"]
    assert "--synthetic" in chain[0][1] and "--synthetic" not in chain[2][1]
    run = chip_smoke.quality_run(SMOKE, root, 2, 2, 1, device="cpu", vggnet=vgg)
    assert list(run["seconds"]) == ["stage 1", "label", "stage 2", "evaluate"]
    assert sorted(run["stage1"]) == sorted(run["stage2"]) == [0, 1, 2]
    for r in run["stage1"].values():
        assert np.isfinite(r["psnr"]) and r["reconstruction_metric"] > 0
    for r in run["stage2"].values():
        assert np.isfinite(r["kl_loss"]) and r["recon_loss"] > 0
    assert (root / "log" / "detector_translator" / "ckpt-3").is_dir()
    assert (root / "log" / "motion_generator" / "ckpt-3").is_dir()
    assert len(list((root / "penn" / "pseudo_labels").glob("*.npy"))) == 6
    assert run["eval_samples"] == 2 and run["tree_ok"]
    sample = sorted((root / "eval").iterdir())[0]
    n_frames = tcfgs.load_config(SMOKE).model.n_future_frames
    assert chip_smoke.png_tree_complete(sample, n_frames)
    sorted((sample / "mask").glob("*.png"))[0].unlink()
    assert not chip_smoke.png_tree_complete(sample, n_frames)


def test_quality_bounds_catch_one_miss():
    """A curve 0.5 dB under JAX's at every step with the KL down 20-fold
    meets every bound; each curve that misses one bound fails on that bound
    alone."""
    jax_curve = chip_smoke.JAX_S1_PSNR
    good = {0: 16.0, 250: 18.0, **{s: v - 0.5 for s, v in jax_curve.items()}}
    kl = {0: 300.0, 1000: 40.0, 2000: 15.0}
    assert chip_smoke.quality_misses(good, kl, 2250, True) == []
    low = {**good, 1000: jax_curve[1000] - 1.6}
    (miss,) = chip_smoke.quality_misses(low, kl, 2250, True)
    assert "step 1000" in miss and "within 1.5 dB" in miss
    high = {**good, 500: jax_curve[500] + 1.6}
    (miss,) = chip_smoke.quality_misses(high, kl, 2250, True)
    assert "step 500" in miss
    # JAX's 23.61 dB less the band is above the floor: a last sweep under
    # 22 dB misses both
    band, floor = chip_smoke.quality_misses({**good, 2250: 21.9}, kl, 2250, True)
    assert "step 2250" in band and "within 1.5 dB" in band and ">= 22.0 dB" in floor
    (miss,) = chip_smoke.quality_misses(good, {**kl, 2000: 31.0}, 2250, True)
    assert "KL at step 2000" in miss
    (miss,) = chip_smoke.quality_misses(good, kl, 2250, False)
    assert "PNG tree" in miss
    missing = {s: v for s, v in good.items() if s != 1500}
    (miss,) = chip_smoke.quality_misses(missing, kl, 2250, True)
    assert "step 1500: None" in miss
