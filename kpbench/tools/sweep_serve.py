"""The serving cell's rate sweep (not run by the benchmark's own runs):

    python kpbench/tools/sweep_serve.py --workload <serve cell> --rates 10 20 30
        [--seconds S] [--seed N] [--device D] [--out F]

runs the cell's driver once per rate in one process and prints, a JSON line
a rate: the offered rate, the share of the window's requests answered by
the window's end and in all, the failures, p50 and p95, and the backlog (the
median latency of the last quarter of the requests over that of the first).
A rate is sustained when every request succeeds, at least 98% are answered
by the window's end and the backlog does not grow (ratio under 1.5); the
workload file keeps 0.8 of the highest sustained rate.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    p = ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from kpbench import harness

    for rate in args.rates:
        cell = harness.Cell.load(args.workload, args.seed, args.seconds, False,
                                 time.perf_counter(), device=args.device)
        cell.notes["rate"] = rate
        driver = harness.load_module(BENCH / "drivers" / f"{cell.workload['kind']}.py",
                                     "kpbench_driver")
        out = driver.run(cell)
        res = json.loads((cell.work / "client" / "results.json").read_text())
        end = min(r["due"] for r in res) + args.seconds
        ok = [r for r in res if r["status"] == 200]
        lat = [(r["done"] - r["due"]) * 1e3 for r in ok]
        q = max(1, len(res) // 4)
        first = [(r["done"] - r["due"]) for r in res[:q] if r["status"] == 200]
        last = [(r["done"] - r["due"]) for r in res[-q:] if r["status"] == 200]
        line = {"rate": rate, "requests": len(res), "failed": len(res) - len(ok),
                "answered_by_end": sum(r["done"] <= end for r in ok) / len(res),
                "p50_ms": statistics.median(lat) if lat else None,
                "p95_ms": out["e2e"]["request_p95_ms"],
                "backlog": (statistics.median(last) / statistics.median(first)
                            if first and last else None),
                "checks": cell.notes.get("readings"), **cell.notes.get("served", {})}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
