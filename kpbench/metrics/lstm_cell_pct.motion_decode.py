"""The share of the motion decode's LSTM steps that ran as the port's
``lstm_cell`` kernel: the device kernels whose name holds ``lstm_cell``,
queued under ``kpvid.generate.motion_decode`` (launched by an op inside it,
or by the ``cudaGraphLaunch`` of its replay, whose kernels the profiler
links to that launch), over the decoder's steps of each ``kpvid.generate``
call of the window, in % (metrics/_spans.py: a kernel counts for the phase
it was queued under). The steps of a call are the decoder's layers
(``cell_info``) times its ``n_future_frames``, from the configuration of
the cells that the BENCHMARK.json beside this reader's kpbench directory
lists for this metric; one launch a step and layer reads 100.

A record with no window or no call reads None, as does a program that has
no such kernel (no ``lstm_cell`` in ``kpvid_tpu_torch.ops``), and a list of
cells whose configurations decode different numbers of steps."""

import importlib
import json
from pathlib import Path

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")

NAME = "lstm_cell_pct.motion_decode"
KERNEL = "lstm_cell"
PHASE = _s.PHASE + "motion_decode"
ROOT = Path(__file__).resolve().parents[1]  # the kpbench directory this reader lies in


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def steps_a_call():
    """Layers x future frames of the decoder, the same in the configuration
    of every cell the metric lists, or None."""
    bench = _json(ROOT.parent / "BENCHMARK.json")
    cells = next(m["workloads"] for m in bench["per_layer"] if m["name"] == NAME)
    steps = set()
    for cell in cells:
        config = _json(ROOT / "workloads" / f"{cell}.json")["config"]
        model = _json(ROOT / "configs" / f"{config}.json")["model"]
        steps.add(len(model["cell_info"]) * model["n_future_frames"])
    return steps.pop() if len(steps) == 1 else None


def read(rec: dict):
    w = _s._window(rec)
    if w is None or not hasattr(importlib.import_module("kpvid_tpu_torch.ops"), KERNEL):
        return None
    steps = steps_a_call()
    if steps is None:
        return None
    lo, hi, calls, phases = w
    launch = {o[6]: o for o in rec["host"]}
    n = 0
    for t0, t1, name, link in rec["device"]:
        if KERNEL not in name or t1 <= lo or t0 >= hi:
            continue
        op = launch.get(link)
        hit = phases.at(op[3], op[0]) if op is not None else None
        n += hit is not None and hit[1] == PHASE
    return 100.0 * n / (steps * calls)
