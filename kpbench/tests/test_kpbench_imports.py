"""The import boundary: what a run of each cell loads has no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``kpvid_tpu`` (compared
whole: ``kpvid_tpu_torch`` is the port), a training cell refuses a result
where its CLI's process loaded one late, and the reference imports nothing
of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, drive

CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(tmp_path, cell):
    """Every cell, BENCHMARK.json's and those kept for later, traced: its
    per-layer readers all find something (but a kernel's roofline: on the
    CPU no kernel is launched), and nothing loaded is JAX's."""
    code = f"""
import json, sys
sys.path.insert(0, {str(BENCH / 'tests')!r})
from pathlib import Path
from conftest import smoke_copy, drive
root = smoke_copy(Path({str(tmp_path)!r}))
result, run = drive(root, {cell!r}, seconds=1.0, trace=True)
from kpbench import harness
names = {{m.split('.')[0] for m in sys.modules}}
child = run.work / "capture" / "modules.json"  # a training cell's CLI process
if child.exists():
    names |= set(json.loads(child.read_text())["names"])
print("TOP", sorted(n for n in names if "kp" in n))
print("FORBIDDEN", sorted(names & set(harness.FORBIDDEN)))
print("MISSING", sorted({{m["name"] for m in run.metrics("per_layer")
                         if not m["name"].endswith("_roofline")}} - set(result["metrics"])))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    top = next(l for l in out.stdout.splitlines() if l.startswith("TOP"))
    assert "kpvid_tpu_torch" in top, top
    assert "FORBIDDEN []" in out.stdout
    assert "MISSING []" in out.stdout, out.stdout[-2000:]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("penn-train.")])
def test_a_late_import_in_the_cli_gives_no_result(smoke, cell):
    """JAX imported in the CLI's loop after the capture of its first steps:
    the run raises, so run.py prints no result."""
    def patch(harness):
        real = harness.Cell.load.__func__

        def load(cls, *a, **k):
            c = real(cls, *a, **k)
            c.notes["fault"] = "late_jax"
            return c

        harness.Cell.load = classmethod(load)

    with pytest.raises(RuntimeError, match=r"imported \['jax'"):
        drive(smoke, cell, seconds=1.0, patch=patch)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("kpvid_tpu_torch", "kpvid_tpu", "jax",
                                                  "jaxlib", "flax"), (path, name)
