"""Serving daemon: micro-batched image + action -> video generation over HTTP.

    python -m kpvid_tpu_torch.serve --config kpvid_tpu/configs/penn.yaml \
        --checkpoint_stage1 stage1.npz --checkpoint_stage2 stage2.npz --port 8000

Counterpart of the JAX package's ``serve.py``. Each checkpoint is the
port's ``.npz`` parameter file (``tools/export_torch_params.py`` writes them
from JAX checkpoints), a trainer ``ckpt-N`` directory
(``python -m kpvid_tpu_torch.train`` writes them), or the directory above
one (its newest ``ckpt-N``). They are merged into the model by name, each of
them required to match at least one tensor, as the JAX CLI merges its two
checkpoints.
Or from a one-file serving artifact (``python -m
kpvid_tpu_torch.export_serving`` writes one; no config, checkpoint or model
code is read):

    python -m kpvid_tpu_torch.serve --artifact serving.npz --port 8000

The daemon runs on the card and raises without one (``--device cpu`` runs
the plain versions on the CPU). Then:

    curl -s localhost:8000/healthz
    python - <<'EOF'
    import base64, json, urllib.request
    body = {"image": base64.b64encode(open("frame.png", "rb").read()).decode(),
            "action": 2, "seed": 7, "format": "gif"}
    r = urllib.request.urlopen(urllib.request.Request(
        "http://localhost:8000/v1/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"}))
    open("pred.gif", "wb").write(r.read())
    EOF

The JAX CLI's ``--mesh`` is not ported.
"""

from __future__ import annotations

import signal
import threading
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch serving daemon")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--checkpoint_stage1", type=str, default=None,
                        help="the port's stage-1 parameter file (.npz), a trainer ckpt-N "
                             "directory or the directory above one")
    parser.add_argument("--checkpoint_stage2", type=str, default=None,
                        help="the port's stage-2 parameter file (.npz), a trainer "
                             "ckpt-N directory, or the directory of its ckpt-N")
    parser.add_argument("--artifact", type=str, default=None,
                        help="serve from a serving artifact (python -m "
                             "kpvid_tpu_torch.export_serving) instead of config + "
                             "checkpoints: ONE file, no model code read. Buckets are the "
                             "artifact's batch sizes")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--buckets", type=int, nargs="+", default=None,
                        help="micro-batch bucket sizes (default 1 2 4 8 16 32)")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="linger after the first queued request before "
                             "dispatching a partial batch")
    parser.add_argument("--max_queue", type=int, default=256,
                        help="pending-request bound; beyond it requests get 503")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip building the kernels and running every bucket "
                             "before binding the port")
    parser.add_argument("--no_pipeline", action="store_true",
                        help="wait for each batch's readback before launching the "
                             "next; outputs are identical either way")
    parser.add_argument("--verbose", action="store_true",
                        help="log one line per HTTP request")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain versions")
    return parser


def load_engine(args):
    """The engine of the parsed arguments, with both parameter files merged."""
    from .configs import load_config
    from .eval import InferenceEngine
    from .eval.final import FinalGenerator

    config = load_config(args.config)
    target = FinalGenerator(config, device="cpu").model.state_dict()
    params = load_generator_parameters(target, args.checkpoint_stage1, args.checkpoint_stage2)
    return InferenceEngine(config, params, device=args.device)


def load_generator_parameters(target: dict, stage1: str, stage2: str) -> dict:
    """``target`` with the tensors of both checkpoints merged in by name
    (each a .npz, a ckpt-N directory or the directory above one)."""
    from .checkpoint import load_parameters, merge_parameters, resolve_parameter_file
    from .utils import logger

    ck1 = resolve_parameter_file(stage1, "--checkpoint_stage1")
    ck2 = resolve_parameter_file(stage2, "--checkpoint_stage2")
    params, n1 = merge_parameters(target, load_parameters(ck1))
    params, n2 = merge_parameters(params, load_parameters(ck2))
    logger.info("restored stage1=%d tensors from %s; stage2=%d from %s", n1, ck1, n2, ck2)
    return params


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .device import resolve_device
    from .eval.server import DEFAULT_BUCKETS, make_server
    from .utils import logger, setup_console_logging

    setup_console_logging()
    if args.artifact:
        if args.config or args.checkpoint_stage1 or args.checkpoint_stage2:
            raise SystemExit("--artifact replaces --config/--checkpoint_stage1/"
                             "--checkpoint_stage2; pass one or the other")
    elif not (args.config and args.checkpoint_stage1 and args.checkpoint_stage2):
        raise SystemExit("pass --config + --checkpoint_stage1 + "
                         "--checkpoint_stage2 (or --artifact)")
    resolve_device(args.device)  # no card: raise before reading anything
    if args.artifact:
        from .eval.export import load_serving
        from .eval.server import ArtifactEngine

        engine = ArtifactEngine(load_serving(args.artifact, device=args.device))
        logger.info("serving artifact %s: buckets %s, traced on %s", args.artifact,
                    list(engine.buckets), engine.artifact.meta["device"])
        buckets = tuple(args.buckets) if args.buckets else engine.buckets
        unknown = set(buckets) - set(engine.buckets)
        if unknown:
            raise SystemExit(f"buckets {sorted(unknown)} not exported in the "
                             f"artifact (has {list(engine.buckets)})")
    else:
        engine = load_engine(args)
        buckets = tuple(args.buckets) if args.buckets else DEFAULT_BUCKETS
    if not args.no_warmup:
        logger.info("warming up %d buckets %s ...", len(buckets), list(buckets))
    server, batcher = make_server(
        engine, host=args.host, port=args.port, buckets=buckets,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        warmup=not args.no_warmup, quiet=not args.verbose,
        pipeline=not args.no_pipeline,
    )
    logger.info("serving on http://%s:%d (POST /v1/generate)", *server.server_address[:2])

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    stop.wait()
    logger.info("shutting down")
    server.shutdown()
    batcher.stop()


if __name__ == "__main__":
    main()
