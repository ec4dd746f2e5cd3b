"""The readings that a cell's check limits are set from (not run by the
benchmark's own runs):

    python kpbench/tools/readings.py --workload <cell> --variant program|control
        --seeds 1 2 3 ... [--seconds S] [--device D] [--fault F]
        [--out readings.jsonl]

runs the cell's driver once per seed in one process, with the program
(``program``) or with the driver's ``control`` in its place, and prints each
run's check values, one JSON line a run. A training cell reads every seed and
each of a comma-separated list of variants at once; ``--fault`` plants one of
its CLI's faults (drivers/_train_child.py) underneath. The lower reading of a
check is the largest that the program's runs give, the upper the smallest the
control's give; kpbench/workloads/<cell>.json keeps the limit set between
them.
"""

from __future__ import annotations

import json
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    p = ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--variant", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rate", type=float, default=None, help="a serving cell's rate")
    p.add_argument("--fault", default=None,
                   help="a training cell's fault planted in its CLI (drivers/_train_child.py)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from kpbench import harness

    first = harness.Cell.load(args.workload, args.seeds[0], args.seconds, False,
                              time.perf_counter(), device=args.device)
    driver = harness.load_module(BENCH / "drivers" / f"{first.workload['kind']}.py",
                                 "kpbench_driver")
    if hasattr(driver, "readings"):  # the driver reads every seed and variant at once
        first.notes["fault"] = args.fault
        for line in driver.readings(first, args.seeds, args.variant.split(",")):
            line.update(workload=args.workload, fault=args.fault)
            print(json.dumps(line), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
        return 0
    for seed in args.seeds:
        cell = harness.Cell.load(args.workload, seed, args.seconds, False, time.perf_counter(),
                                 device=args.device)
        driver = harness.load_module(BENCH / "drivers" / f"{cell.workload['kind']}.py",
                                     "kpbench_driver")
        if args.variant != "program":
            cell.notes["program"] = getattr(driver, args.variant)
        if args.rate is not None:
            cell.notes["rate"] = args.rate
        t = time.perf_counter()
        try:
            out = driver.run(cell)
            line = {"workload": args.workload, "variant": args.variant, "seed": seed,
                    "checks": cell.notes.get("readings") or {k: v for k, (v, _) in
                                                             out["checks"].items()},
                    "attempted": out["attempted"], "failed": out["failed"],
                    "e2e": out["e2e"], "s": time.perf_counter() - t}
        except Exception as exc:  # a control that crashes has failed, and reads nothing
            line = {"workload": args.workload, "variant": args.variant, "seed": seed,
                    "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
