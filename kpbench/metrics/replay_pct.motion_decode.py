"""The share of the traced window's generate calls whose motion decode was a
CUDA graph replay: the ``kpvid.graph.motion_decode`` ranges inside the window
over its ``kpvid.generate`` calls, in %. The port opens that range around
each replay of ``eval/final.py::GraphedDecode`` and nowhere else; on the CPU
the decode runs eager, and the share reads 0.

A record with no window or no call reads None, as does a program that has no
graphed decode (no ``GraphedDecode`` in ``kpvid_tpu_torch.eval.final``)."""

import importlib

from kpbench import harness

_s = harness.load_module(harness.BENCH / "metrics" / "_spans.py", "kpbench_metric__spans")

REPLAY = "kpvid.graph.motion_decode"


def read(rec: dict):
    w = _s._window(rec)
    if w is None or not hasattr(importlib.import_module("kpvid_tpu_torch.eval.final"),
                                "GraphedDecode"):
        return None
    lo, hi, calls, _ = w
    replays = sum(1 for o in rec["host"] if o[2] == REPLAY and o[0] >= lo and o[1] <= hi)
    return 100.0 * replays / calls
