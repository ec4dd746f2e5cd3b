"""Run one cell of the benchmark of ``kpvid_tpu_torch`` once.

    python kpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by its name
(kpbench/harness.py). With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of part of the window by kpbench/metrics/<name>.py.
The last line of standard output is the result; the last lines of standard
error are the numbers that decide ``correct``, each beside its limit. It
exits 1 without a result where there is no card, too few cards, or where
JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from argparse import ArgumentParser  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

# every cache inside the checkout, at fixed paths; libraries that would load
# JAX on their own are told not to
for var, sub in (("TORCH_EXTENSIONS_DIR", ".cache/torch_extensions"),
                 ("TRITON_CACHE_DIR", ".cache/triton"),
                 ("CUDA_CACHE_PATH", ".cache/nv_compute_cache"),
                 ("KPVID_TORCH_BUILD_DIR", "../build/kpvid_tpu_torch")):
    os.environ[var] = str((BENCH / sub).resolve())
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from kpbench import harness

    cell = harness.Cell.load(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    import torch

    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    driver = harness.load_module(BENCH / "drivers" / f"{cell.workload['kind']}.py",
                                 f"kpbench_driver_{cell.workload['kind']}")
    out = driver.run(cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: the run imported {bad}", file=sys.stderr)
        return 1
    harness.emit(cell, **harness.read_layers(cell, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
