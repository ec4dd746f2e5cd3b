"""Headline benchmark: generated video frames per second.

    python -m kpvid_tpu_torch.bench [--mesh] [--batch 32]

Counterpart of the root ``bench.py``: the fused generation path
(``FinalGenerator.generate``: pose-encode one image, decode 32 keypoint
frames, render the maps, translate B * 32 frames at 128x128, blend) at
``Config()`` in bf16, on JAX's inputs: the weights of
``init_variables(PRNGKey(0))`` (``FinalGenerator.init_parameters(0)``), the
images ``uniform(PRNGKey(2), -1, 1)``, the latents of warm-up call ``i``
``normal(PRNGKey(100 + i))`` and of round ``r``'s call ``i``
``normal(PRNGKey(8 r + i))`` (utils/jax_random.py), ``--batch`` images a call,
through eval/final.py::GeneratorMesh over the one device (with ``--mesh``
over every visible card, the batch rounded to a multiple of the card
count, each card's replica taking its rows). Three warm-up calls build
the kernels and let cuDNN choose; then three rounds of 8 calls, each ending
in ``torch.cuda.synchronize()`` of every replica's card; the best round counts. It prints one JSON
line, ``{"metric": "generated_frames_per_sec_per_chip", "value", "unit"}``,
the value computed as ``bench.py`` computes it: every generated frame of
the round over its seconds (with ``--mesh``, the frames of every card).

``bench.py``'s ``vs_baseline`` (the value over a TPU's 2,000 frames/s) is
not printed: no TPU number is a target for the card. Nor is its
``--conv-backend``: the port's translator always runs the conv kernels (#1
and #2, ops/chain.py). The run is on the card and raises without one
(``--device cpu`` runs the plain versions on the CPU).
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser

import numpy as np

from .utils import jax_random

ITERS, ROUNDS, WARMUP = 8, 3, 3


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch generation benchmark")
    parser.add_argument("--mesh", action="store_true",
                        help="generate batch-parallel over every visible card from one "
                             "process (one replica of the parameters per card)")
    parser.add_argument("--batch", type=int, default=32,
                        help="images per call (x32 frames each)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain versions")
    return parser


def inputs(config, batch: int) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """JAX ``bench.py``'s inputs at ``batch``: the images, the action one-hots
    (class 0) and the latents of the warm-up calls, then of the timed calls
    in order."""
    m = config.model
    im = jax_random.uniform(jax_random.PRNGKey(2), (batch, m.image_size, m.image_size, 3),
                            np.float32, -1.0, 1.0)
    act = np.zeros((batch, m.n_action), np.float32)
    act[:, 0] = 1.0
    seeds = [100 + i for i in range(WARMUP)] + list(range(ITERS * ROUNDS))
    zs = [jax_random.normal(jax_random.PRNGKey(s), (batch, m.vae_dim)) for s in seeds]
    return im, act, zs


def main(argv=None) -> dict:
    """Run the benchmark; print and return its JSON record."""
    args = build_parser().parse_args(argv)
    from .configs import Config
    from .device import resolve_device
    from .eval.final import FinalGenerator, GeneratorMesh, mesh_devices

    device = resolve_device(args.device)
    config = Config().validate()  # production scale: 128^2, K = 40, LSTM 2 x 1024, T = 32
    m = config.model
    params = FinalGenerator(config, device="cpu").init_parameters(0)
    mesh = GeneratorMesh(config, params, mesh_devices(device) if args.mesh else [device])
    batch = max(args.batch, mesh.n_data) // mesh.n_data * mesh.n_data

    def generate(im, act, z):
        return mesh.map(lambda rep, *rows: rep.final.generate(*rows), im, act, z)

    im, act, zs = inputs(config, batch)
    for i in range(WARMUP):
        generate(im, act, zs[i])
        mesh.synchronize()
    best = float("inf")
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        for i in range(ITERS):
            generate(im, act, zs[WARMUP + r * ITERS + i])
        mesh.synchronize()
        best = min(best, time.perf_counter() - t0)
    frames = batch * m.n_future_frames * ITERS
    record = {"metric": "generated_frames_per_sec_per_chip", "value": round(frames / best, 1),
              "unit": "frames/s"}
    print(json.dumps(record), flush=True)
    return dict(record, batch=batch, n_data=mesh.n_data, best_round_s=best, device=str(device))


if __name__ == "__main__":
    main()
