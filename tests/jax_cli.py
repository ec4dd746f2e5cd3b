"""The JAX package's root CLIs in processes of their own on one CPU device,
and what the port's tests compare with their output.

``start`` launches ``python <script> <args>`` from the repo root without
conftest's 8 virtual devices (a one-device run, as ``tests/test_cli.py``
runs them), its output into a log file; ``finish`` waits for it and fails
with the log. Several may run at once. ``first_grads`` records each
parameter's first update's gradient in the port's trainers (the sign-step
exceptions of the parity tolerances need it), ``jsonl`` reads a metric
log, and ``png_steps`` the largest pixel difference of two summary trees.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def start(script: str, args: list, log: Path) -> tuple[subprocess.Popen, Path]:
    env = dict(os.environ, JAX_PLATFORMS="cpu", KPVID_PLATFORM="cpu")
    env.pop("XLA_FLAGS", None)
    out = open(log, "w")
    try:
        proc = subprocess.Popen([sys.executable, str(REPO / script)] + [str(a) for a in args],
                                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    finally:
        out.close()
    return proc, log


def finish(run: tuple[subprocess.Popen, Path], timeout: float = 600) -> None:
    proc, log = run
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    assert rc == 0, f"{proc.args} exited {rc}:\n{log.read_text()[-6000:]}"


@contextlib.contextmanager
def first_grads():
    """Within the block, every port trainer's update records each
    parameter's first gradient: {id(parameter): gradient}."""
    from kpvid_tpu_torch.train.state import GANTrainer

    seen: dict = {}
    apply = GANTrainer._apply

    def recording(self, opt, params, grads):
        for p, g in zip(params, grads):
            seen.setdefault(id(p), g.detach().clone())
        return apply(self, opt, params, grads)

    GANTrainer._apply = recording
    try:
        yield seen
    finally:
        GANTrainer._apply = apply


def named_grads(trainer, seen: dict) -> dict:
    return {name: seen[id(p)] for name, p in trainer.model.named_parameters()}


def jsonl(path: Path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def assert_metric_logs_match(got: Path, want: Path, rtol: float) -> int:
    """Each line's step and every metric (not the time) within ``rtol``;
    returns the lines compared."""
    g, w = jsonl(got), jsonl(want)
    assert [x["step"] for x in g] == [x["step"] for x in w]
    for a, b in zip(g, w):
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        for k in b:
            if k not in ("step", "time"):
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=f"step {b['step']} {k}")
    return len(w)


def png_steps(got: Path, want: Path) -> tuple[int, int]:
    """(files, the largest difference of a pixel in uint8 steps) of two
    directories of the same PNG names."""
    from PIL import Image

    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == names
    worst = 0
    for name in names:
        a, b = (np.asarray(Image.open(io.BytesIO((d / name).read_bytes())), np.int16)
                for d in (got, want))
        assert a.shape == b.shape, name
        worst = max(worst, int(np.abs(a - b).max()))
    return len(names), worst
