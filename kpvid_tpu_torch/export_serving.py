"""Write the one-file serving artifact: the generation graph with the weights in it.

    python -m kpvid_tpu_torch.export_serving --config kpvid_tpu_torch/configs/penn.yaml \
        --checkpoint_stage1 stage1.npz --checkpoint_stage2 stage2.npz \
        --out serving.npz [--batch-sizes 1,32] [--device cuda]

Counterpart of the JAX package's ``tools/export_serving.py``. The
checkpoints are what ``python -m kpvid_tpu_torch.serve`` takes (the port's
``.npz`` parameter files, trainer ``ckpt-N`` directories or the directory
above one), merged the same way. One program per batch size is traced with
``torch.export`` on ``--device`` (the card by default; ``cpu`` needs none)
and written by ``eval/export.py::export_serving``; a program traced on
either device runs on both. Serve it with

    python -m kpvid_tpu_torch.serve --artifact serving.npz

Prints one JSON line: the artifact's path, its bytes, the export's seconds,
the batch sizes, the device and the output names.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser
from pathlib import Path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="write a kpvid_tpu_torch serving artifact")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint_stage1", type=str, required=True)
    parser.add_argument("--checkpoint_stage2", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--batch-sizes", type=str, default="1,32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the programs are traced: 'cuda' (default) or 'cpu'")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from .configs import load_config
    from .eval.export import export_serving
    from .eval.final import FinalGenerator
    from .serve import load_generator_parameters
    from .utils import setup_console_logging

    setup_console_logging()
    final = FinalGenerator(load_config(args.config), device=args.device)
    final.load_parameters(load_generator_parameters(  # into JAX's PRNGKey(0) tree
        final.init_parameters(0), args.checkpoint_stage1, args.checkpoint_stage2))
    batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b]
    t0 = time.monotonic()
    meta = export_serving(final, args.out, batch_sizes=batch_sizes)
    report = {
        "artifact": str(args.out),
        "bytes": Path(args.out).stat().st_size,
        "export_s": round(time.monotonic() - t0, 1),
        **{k: meta[k] for k in ("batch_sizes", "device", "outputs")},
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
