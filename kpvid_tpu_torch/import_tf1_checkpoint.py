"""Convert a reference TF1 checkpoint into a trainer checkpoint of the port.

    python -m kpvid_tpu_torch.import_tf1_checkpoint --config kpvid_tpu_torch/configs/penn.yaml \
        --stage 1 --tf-checkpoint /path/to/model.ckpt-200000 [--log-dir results/]

Counterpart of the JAX package's ``import_tf1_checkpoint.py``, with no
TensorFlow: the bundle is read by ``utils/tf_bundle.py`` and the names are
mapped by ``utils/tf1_import.py``. It builds the stage's trainer (stage 1
with synthesized VGG19 weights, which are not saved), initializes it from
seed 0, grafts the generator (with the BN statistics in stage 1) and the
discriminator by name, and writes
``{log_dir}/{detector_translator|motion_generator}/ckpt-{step}/`` with a
fresh Adam state. Tensors the checkpoint lacks, or holds in another shape,
keep their init, with a warning; no generator tensor matched is an error.
``train`` resumes from the directory, and ``serve``, ``evaluate`` and
``make_pseudo_labels`` take it as they take the trainer's own checkpoints;
the first update after ``--step N`` takes the learning rate of a fresh
optimizer (``lr(0)``), as JAX's does. It runs on the card by default
(``--device cpu`` on the CPU); nothing here launches a kernel.
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="import a reference TF1 checkpoint into the port")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--stage", type=int, required=True, choices=[1, 2])
    parser.add_argument("--tf-checkpoint", type=str, required=True)
    parser.add_argument("--log-dir", type=str, default=None,
                        help="defaults to paths.log_dir from the config")
    parser.add_argument("--step", type=int, default=0,
                        help="step number for the written checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None) -> dict:
    """Import; returns the checkpoint's path and the two reports."""
    args = build_parser().parse_args(argv)
    from .checkpoint import save_checkpoint
    from .configs import load_config
    from .device import resolve_device
    from .utils import logger, setup_console_logging
    from .utils.tf1_import import transcode_tf1_checkpoint

    setup_console_logging()
    device = resolve_device(args.device)
    config = load_config(args.config)
    log_dir = args.log_dir or config.paths.log_dir
    if args.stage == 1:
        from .losses import synthesize_vgg19_params
        from .train import Stage1Trainer

        trainer = Stage1Trainer(config, synthesize_vgg19_params(), device=device)
        name = "detector_translator"
    else:
        from .train import Stage2Trainer

        trainer = Stage2Trainer(config, device=device)
        name = "motion_generator"
    trainer.load_parameters(trainer.init_parameters(0))
    state = trainer.model.state_dict()
    reports = {}
    for part, prefix in (("generator", trainer.G_PREFIX), ("discriminator", trainer.D_PREFIX)):
        target = {k: v for k, v in state.items() if k.startswith(prefix + ".")}
        stage = f"stage{args.stage}" + ("_discr" if part == "discriminator" else "")
        merged, reports[part] = transcode_tf1_checkpoint(args.tf_checkpoint, target, stage)
        state.update(merged)
    g_report, d_report = reports["generator"], reports["discriminator"]
    if not g_report["matched"]:
        raise SystemExit(
            f"no generator tensors matched in {args.tf_checkpoint} - wrong "
            f"stage or config? missing={g_report['missing'][:5]}..."
        )
    for tag, rep in reports.items():
        for tf_name, got, want in rep["mismatched"]:
            logger.warning("%s shape mismatch %s: ckpt %s vs model %s", tag, tf_name, got, want)
        if rep["missing"]:
            logger.warning("%s: %d mapped names absent from checkpoint (first: %s)", tag,
                           len(rep["missing"]), rep["missing"][:3])
    trainer.load_parameters(state)
    trainer.step = args.step
    path = save_checkpoint(log_dir, name, args.step, trainer.state_arrays(),
                           keep=config.training.keep_checkpoints)
    logger.info("transcoded %d generator + %d discriminator tensors -> %s",
                len(g_report["matched"]), len(d_report["matched"]), path)
    print(f"wrote {path}")
    return {"path": Path(path), "generator": g_report, "discriminator": d_report}


if __name__ == "__main__":
    main()
