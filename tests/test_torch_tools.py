"""The port's three tools against the JAX package's, on the CPU.

- ``python -m kpvid_tpu_torch.bench_train --device cpu`` at smoke widths
  (``Config()`` swapped for them, small batches, VGG19 8 channels wide):
  one JSON line with the three points, both forms, and no ``vs_baseline``;
- ``kpvid_tpu_torch.verify_reference_parity``: its PSNR functions give the
  numbers of ``tools/verify_reference_parity.py``'s on the same two PNG
  trees; end to end on bundles written by ``chip_smoke.write_tf_bundle`` at
  smoke widths, its renders are the port's ``evaluate`` tree byte for byte,
  it passes against that tree and exits 1 against the tree with every
  predicted pixel moved 2 uint8 steps away from the real frame, at
  ``--tolerance-db 0.01``;
- ``kpvid_tpu_torch.bench_host_pipeline``: its tree (2 videos of 4 frames)
  is the JAX tool's byte for byte, and a batch runs with the cache and
  without;
- ``bench_train.profile_totals``, which the tool and ``chip_smoke.py`` read
  their profiles with: ``key_averages()``'s counts and times.
"""

import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from kpvid_tpu_torch import bench_host_pipeline, bench_train, configs, evaluate, losses
from kpvid_tpu_torch import import_tf1_checkpoint, verify_reference_parity
from kpvid_tpu_torch.data import make_synthetic_penn_tree, make_synthetic_pseudo_labels

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import tf1_bundles  # noqa: E402

SMOKE = dict(n_pts=4, n_action=3, cell_info=(16, 16), vae_dim=8, n_future_frames=6,
             image_size=32, heatmap_size=8, encoder_filters=8, translator_filters=16,
             pose_decoder_filters=16, discriminator_filters=8)


def jax_tool(name: str):
    """A JAX tool of ``tools/`` as a module (the tests may import it; the
    port may not)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree_bytes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ------------------------------------------------------------ bench_train
def test_bench_train_prints_one_json_line(capsys, monkeypatch):
    """The three points at small batches, each with both forms' ms a step,
    examples/s and capture time; one JSON line, JAX's metric and unit, the
    value the throughput point's eager examples/s, and no vs_baseline or TPU
    number; device time and memory not measured on the CPU."""
    smoke = configs.Config(model=configs.ModelConfig(**SMOKE)).validate()
    synth = losses.synthesize_vgg19_params
    monkeypatch.setattr(configs, "Config", lambda: smoke)
    monkeypatch.setattr(losses, "synthesize_vgg19_params", lambda: synth(max_width=8))
    points = (("stage1_parity", 1, 2), ("stage1_throughput", 1, 4), ("stage2", 2, 4))
    with mock.patch.multiple(bench_train, POINTS=points, WINDOWS=1, WARMUP=1):
        line = bench_train.main(["--device", "cpu", "--iters", "2", "--k", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == line
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["metric"] == "stage1_train_examples_per_sec_per_chip"
    assert line["unit"] == "examples/s"
    detail = line["detail"]
    assert set(detail) == {"stage1_parity", "stage1_throughput", "stage2", "device"}
    assert detail["device"] == "cpu"
    for tag, _, bs in points:
        rec = detail[tag]
        assert rec["batch"] == bs
        for form in ("eager", "graphed"):
            r = rec[form]
            assert r["ms_per_step"] > 0 and r["examples_per_s"] == pytest.approx(
                bs / r["ms_per_step"] * 1e3)
            assert r["device_ms"] is None and r["peak_gib"] is None
        assert rec["graphed"]["k"] == 2
    assert line["value"] == round(detail["stage1_throughput"]["eager"]["examples_per_s"], 1)
    assert "upsample_mode" in detail["stage1_throughput"]["note"]
    assert "vs_baseline" not in json.dumps(line)


# ------------------------------------------------- verify_reference_parity
def _png_tree(root: Path, samples: int, seed: int, with_real: bool) -> None:
    rng = np.random.default_rng(seed)
    for i in range(samples):
        for sub in ("pred_seq", "real_seq") if with_real else ("pred_seq",):
            d = root / f"{i:04d}" / sub
            d.mkdir(parents=True)
            for t in range(3):
                im = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                Image.fromarray(im).save(d / f"{t:06d}.png")


def test_parity_functions_match_jaxs(tmp_path):
    """pred_vs_real_psnr and compare_against_reference: the JAX tool's
    numbers on the same trees (ours of 3 samples; a reference of 2 of them,
    so the matched subset counts), verdict and refusal included."""
    jax_vrp = jax_tool("verify_reference_parity")
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    _png_tree(ours, 3, 0, True)
    _png_tree(ref, 2, 1, False)
    samples = sorted(ours.glob("[0-9]*"))
    assert verify_reference_parity.pred_vs_real_psnr(ours, samples) == \
        jax_vrp.pred_vs_real_psnr(ours, samples)
    for tol in (0.01, 5.0):
        got = verify_reference_parity.compare_against_reference(ours, ref, samples, tol)
        assert got == jax_vrp.compare_against_reference(ours, ref, samples, tol)
    assert not got[0] or got[3] <= 5.0
    with pytest.raises(SystemExit, match="no matching"):
        verify_reference_parity.compare_against_reference(ours, tmp_path / "none", samples, 0.1)


@pytest.fixture(scope="module")
def parity_setup(tmp_path_factory):
    """A synthetic tree, a config at smoke widths (f32), both stages' TF1
    bundles (``chip_smoke.tf1_bundles``), their imports and the port's
    evaluate tree of them."""
    root = tmp_path_factory.mktemp("parity")
    data = root / "penn"
    make_synthetic_penn_tree(data, n_train=2, n_test=3, frames_per_video=12)
    make_synthetic_pseudo_labels(data, n_pts=SMOKE["n_pts"])
    conf = root / "cfg.yaml"
    conf.write_text(json.dumps({  # JSON is YAML
        "paths": {"data_dir": str(data)}, "training": {"compute_dtype": "float32"},
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in SMOKE.items()},
        "data": {"num_workers": 2, "eval_batch_size": 2, "sequence_len": 7}}))
    cfg = configs.load_config(conf)
    bundles = tf1_bundles(cfg, {}, root)
    imported = root / "imported"
    for stage in (1, 2):
        import_tf1_checkpoint.main(["--config", str(conf), "--stage", str(stage),
                                    "--tf-checkpoint", str(bundles[stage]["prefix"]),
                                    "--log-dir", str(imported), "--device", "cpu"])
    evaluate.main(["--config", str(conf), "--checkpoint_stage1",
                   str(imported / "detector_translator"), "--checkpoint_stage2",
                   str(imported / "motion_generator"), "--save_dir", str(root / "eval"),
                   "--batch_size", "2", "--device", "cpu"])
    return {"root": root, "conf": conf, "bundles": bundles, "eval": root / "eval"}


def _harness(setup, work: str, *extra) -> int:
    b = setup["bundles"]
    return verify_reference_parity.main([
        "--config", str(setup["conf"]), "--tf-checkpoint-stage1", str(b[1]["prefix"]),
        "--tf-checkpoint-stage2", str(b[2]["prefix"]), "--work-dir", str(setup["root"] / work),
        "--batch-size", "2", "--device", "cpu", *extra])


def test_parity_harness_end_to_end(parity_setup, capsys):
    """The harness on the two bundles: its renders are the port's evaluate
    tree of the same imports byte for byte, and it passes against that tree
    with a delta of 0.000 dB."""
    rc = _harness(parity_setup, "work", "--reference-outputs", str(parity_setup["eval"]))
    out = capsys.readouterr().out
    assert rc == 0 and "PASS: |ours - reference| = 0.000 dB" in out
    assert "pred-vs-real PSNR over 3 samples (18 frames)" in out
    got, want = tree_bytes(parity_setup["root"] / "work" / "renders"), tree_bytes(
        parity_setup["eval"])
    assert len(want) == 3 * (2 + 5 * SMOKE["n_future_frames"]) and got == want


def test_parity_harness_fails_on_a_shifted_tree(parity_setup, capsys, tmp_path):
    """Against the evaluate tree with every predicted pixel moved 2 uint8
    steps away from the real frame's, at --tolerance-db 0.01: FAIL, exit
    code 1."""
    shifted = tmp_path / "shifted"
    for pred in sorted(parity_setup["eval"].glob("*/pred_seq/*.png")):
        real = pred.parent.parent / "real_seq" / pred.name
        p = np.asarray(Image.open(pred)).astype(np.int16)
        r = np.asarray(Image.open(real)).astype(np.int16)
        away = np.where(p >= r, np.minimum(p + 2, 255), np.maximum(p - 2, 0))
        dst = shifted / pred.relative_to(parity_setup["eval"])
        dst.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(away.astype(np.uint8)).save(dst)
    rc = _harness(parity_setup, "work_shifted", "--reference-outputs", str(shifted),
                  "--tolerance-db", "0.01")
    assert rc == 1 and "FAIL: |ours - reference|" in capsys.readouterr().out


# ----------------------------------------------------- bench_host_pipeline
def test_host_pipeline_tree_and_one_batch(tmp_path, capsys):
    """build_tree at 2 videos of 4 frames writes the JAX tool's bytes; the
    bench runs a batch of each (cache, workers) and reads the cache's
    residency and hit rate."""
    jax_bhp = jax_tool("bench_host_pipeline")
    jax_bhp.build_tree(tmp_path / "jax", n_videos=2, frames=4)
    bench_host_pipeline.build_tree(tmp_path / "port", n_videos=2, frames=4)
    want = tree_bytes(tmp_path / "jax")
    assert len(want) == 2 * 4 + 2 and tree_bytes(tmp_path / "port") == want
    rows = bench_host_pipeline.main(["--root", str(tmp_path / "port"), "--batch", "2",
                                     "--batches", "1"])
    out = capsys.readouterr().out
    assert [(r["cache_mb"], r["workers"]) for r in rows] == [
        (c, w) for c in (0, 1024) for w in (1, 2, 4, "auto")]
    assert all(r["examples_per_s"] > 0 for r in rows)
    assert all(r["hit_rate"] == 1.0 and r["resident_mb"] > 0 for r in rows if r["cache_mb"])
    assert "device demand" not in out and len(out.splitlines()) == 1 + len(rows)


def test_bench_train_points_are_jaxs():
    """The points are the JAX tool's (its baseline's keys): stage 1 at 16
    and 128, stage 2 at 64."""
    assert [(t, b) for t, _, b in bench_train.POINTS] == [
        ("stage1_parity", 16), ("stage1_throughput", 128), ("stage2", 64)]
    assert [t for t, _, _ in bench_train.POINTS] == list(jax_tool("bench_train").R3_EX_PER_S)


def test_profile_totals_read_what_key_averages_reads():
    """``bench_train.profile_totals`` reads a profile's raw records: per
    host op the count and µs of ``key_averages()`` (no op here nests a
    record of its own name, which key_averages() folds)."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.relu(torch.mm(x, x) + 1.0)
    device, host = bench_train.profile_totals(prof)
    want = {e.key: (e.count, e.cpu_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CPU}
    assert device == {}
    assert sorted(host) == sorted(want)
    for key, (n, us) in host.items():
        assert n == want[key][0]
        assert us == pytest.approx(want[key][1], rel=1e-6, abs=1e-3)
