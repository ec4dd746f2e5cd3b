"""The tools that set a cell's limits and a serving cell's rate, and the cut
of stage 2's gradient gap, run on the CPU at smoke widths, in a process of
their own from the copy's root, and print one JSON line for each seed or
rate."""

from __future__ import annotations

import json
import subprocess
import sys


def run_tool(root, *argv) -> list:
    out = subprocess.run([sys.executable, str(root / "tools" / argv[0]), *argv[1:],
                          "--device", "cpu"], capture_output=True, text=True, timeout=600,
                         cwd=root.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]


def test_readings_of_the_program_and_the_control(smoke):
    for variant in ("program", "control"):
        lines = run_tool(smoke, "readings.py", "--workload", "penn-final.offline-b32",
                         "--variant", variant, "--seeds", "3", str(2**31 + 9), "--seconds", "0.5")
        assert [l["seed"] for l in lines] == [3, 2**31 + 9]
        assert all(set(l["checks"]) >= {"frames", "masks", "frames_mean"} for l in lines)


def test_rate_sweep(smoke):
    lines = run_tool(smoke, "sweep_serve.py", "--workload", "penn-final.serve-open",
                     "--rates", "4", "8", "--seconds", "1")
    assert [l["rate"] for l in lines] == [4.0, 8.0]
    assert all(l["failed"] == 0 and l["requests"] > 0 for l in lines)


def test_stage2_kl_cut(smoke):
    """At f32 the program reads the reference exactly; the encoder's
    gradient is the KL log term's, and the decoder's has none of it."""
    lines = run_tool(smoke, "stage2_kl_cut.py", "--seeds", "11", "12")
    assert [l["seed"] for l in lines] == [11, 12]
    for l in lines:
        assert l["program"]["worst"] == 0.0
        share = l["log_term_share"]
        assert share["stage2.enc_head.weight"] > 0.9 and share["stage2.dec_lstm.lstm_0_kernel"] == 0
