"""One rank of the port's tensor-parallel runs for tests/test_torch_tensor_parallel.py.

Started D x M times by the test (tests/test_torch_parallel.py::Spawn), with
the KPVID_* environment (gloo on the CPU); imports nothing of JAX. It reads
a job (JSON) and, on the mesh ``data`` x ``model`` (rank r at (r // M,
r % M)):

- builds each stage's trainer with ``parallel.min_shard_dim`` 16
  (``parallel.make_dp_reduce_step``), loads the full parameters the test
  wrote, runs one f32 'fused' step on the rows of its data coordinate
  (coordinate d holds rows [d*b, (d+1)*b)) and keeps the metrics, the
  gathered arrays (``state_arrays``) and, of every sharded array, its own
  local slice and shape;
- with ``cli``: ``python -m kpvid_tpu_torch.train --mode motion_generator
  --mesh-model M``'s ``main`` for 3 steps from the seed, then again from a
  one-process ``ckpt-2``.

Each rank writes ``rank{r}.npz`` and ``rank{r}.json``.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kpvid_tpu_torch import configs as tcfgs  # noqa: E402
from kpvid_tpu_torch import parallel  # noqa: E402
from kpvid_tpu_torch.losses import synthesize_vgg19_params  # noqa: E402
from kpvid_tpu_torch.train.state import optimizer_arrays  # noqa: E402


def main() -> None:
    job = json.loads(Path(sys.argv[1]).read_text())
    out = Path(job["out"])
    torch.set_num_threads(1)
    parallel.maybe_initialize("cpu")
    rank, world = parallel.world()
    mesh = parallel.make_mesh(n_model=job["model"])
    info = {"rank": rank, "world": world, "coords": [mesh.d, mesh.m], "shape": mesh.shape}
    res = {}
    for stage in (1, 2):
        spec = job[f"stage{stage}"]
        cfg = tcfgs.Config(model=tcfgs.ModelConfig(**spec["model"]),
                           training=tcfgs.TrainingConfig(**spec["training"]),
                           parallel=tcfgs.ParallelConfig(mesh_model=job["model"],
                                                         min_shard_dim=job["min_shard_dim"])
                           ).validate()
        vgg = synthesize_vgg19_params(max_width=spec["vgg_width"]) if stage == 1 else None
        trainer, step = parallel.make_dp_reduce_step(cfg, stage, mesh, vgg, device="cpu")
        init = np.load(spec["init"])
        trainer.load_parameters({k: init[k] for k in init.files})
        data = np.load(spec["batch"])
        b = cfg.training.batch_size // mesh.data
        rows = slice(mesh.d * b, (mesh.d + 1) * b)
        batch = {k: data[k][rows] for k in data.files if k != "noise"}
        metrics = step(batch) if stage == 1 else step(batch, data["noise"])
        info[f"s{stage}_metrics"] = {k: float(v) for k, v in metrics.items()}
        local = {**trainer.model.state_dict(),
                 **optimizer_arrays(trainer.g_opt, trainer._g_names, f"g_opt.{trainer.G_PREFIX}"),
                 **optimizer_arrays(trainer.d_opt, trainer._d_names, f"d_opt.{trainer.D_PREFIX}")}
        info[f"s{stage}_rules"] = trainer.array_rules
        info[f"s{stage}_local_shapes"] = {k: list(v.shape) for k, v in local.items()}
        res.update({f"s{stage}_local/{k}": v.numpy() for k, v in local.items()
                    if k in trainer.array_rules})
        res.update({f"s{stage}_full/{k}": v.numpy() for k, v in trainer.state_arrays().items()})
    if job.get("cli"):
        from kpvid_tpu_torch.train import main as train_main

        for name in ("cli_tp", "cli_resume"):
            run = train_main(job[name])
            info[name] = {"start_step": run["start_step"], "end_step": run["end_step"],
                          "metrics": run["metrics"]}
    np.savez(out / f"rank{rank}.npz", **res)
    (out / f"rank{rank}.json").write_text(json.dumps(info))


if __name__ == "__main__":
    main()
