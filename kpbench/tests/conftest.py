"""Shared pieces of the benchmark's own tests: a copy of ``kpbench`` with its
configurations cut to smoke widths (the CPU tests run the drivers there,
``device="cpu"``), and a runner that drives one cell in this process."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(REPO))

SMOKE_MODEL = dict(n_pts=8, cell_info=[64, 64], vae_dim=16, image_size=32, heatmap_size=8,
                   encoder_filters=8, translator_filters=16, pose_decoder_filters=16,
                   discriminator_filters=8, n_future_frames=4)


def smoke_copy(dst: Path, dtype: str = "float32") -> Path:
    """``dst/kpbench`` and ``dst/BENCHMARK.json``: the benchmark with every
    configuration at smoke widths in ``dtype``, small batches and trees, and
    ``dst/kpvid_tpu_torch`` a link to the port. Returns ``dst/kpbench``."""
    shutil.copytree(BENCH, dst / "kpbench",
                    ignore=shutil.ignore_patterns(".work", ".cache", ".data", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "kpvid_tpu_torch").symlink_to(REPO / "kpvid_tpu_torch")
    root = dst / "kpbench"
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["model"].update(SMOKE_MODEL)
        if "batch_size" in cfg["training"]:  # the data's sequences keep their 32 frames
            cfg["model"]["n_future_frames"] = 32
        cfg["training"]["compute_dtype"] = dtype
        if "batch_size" in cfg["training"]:
            cfg["training"].update(batch_size=4, summary_interval=2, log_interval=2)
            cfg["vgg_max_width"] = 16
            cfg["data"] = {"num_workers": 2}
        path.write_text(json.dumps(cfg))
    for path in (root / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        if wl["kind"] == "offline":
            wl.update(batch=4, check_rows=2)
        elif wl["kind"] == "train_cli":
            wl.update(warmup_steps=4, tree=dict(wl["tree"], n_train=4, n_test=2))
        elif wl["kind"] == "serve_open":
            wl["traffic"].update(rate=8.0, warmup_requests=4)
            wl.update(trace_seconds=1, sample_requests=3)
        path.write_text(json.dumps(wl))
    return root


def drive(root: Path, name: str, seed: int = 2**31 + 5, seconds: float = 2.0,
          trace: bool = False, program=None, patch=None) -> tuple[dict, object]:
    """One run of cell ``name`` of the copy at ``root`` on the CPU, as
    run.py makes it after its look for a card; (result line, cell). ``patch``
    is called with the copy's harness module first."""
    import importlib

    sys.path.insert(0, str(root.parent))
    for mod in [m for m in sys.modules if m == "kpbench" or m.startswith("kpbench.")]:
        del sys.modules[mod]
    harness = importlib.import_module("kpbench.harness")
    if patch is not None:
        patch(harness)
    cell = harness.Cell.load(name, seed, seconds, trace, time.perf_counter(), root=root,
                             device="cpu")
    driver = harness.load_module(root / "drivers" / f"{cell.workload['kind']}.py",
                                 f"kpbench_driver_{cell.workload['kind']}")
    if program is not None:
        cell.notes["program"] = program(driver) if callable(program) else program
    out = driver.run(cell)
    import io

    buf = io.StringIO()
    result = harness.emit(cell, **harness.read_layers(cell, out), stream=buf)
    sys.path.remove(str(root.parent))
    return result, cell


@pytest.fixture
def smoke(tmp_path):
    return smoke_copy(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels and the cell's own sizes")
    return torch.device("cuda")
