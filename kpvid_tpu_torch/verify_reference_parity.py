"""One-command fidelity harness against a pretrained reference.

    python -m kpvid_tpu_torch.verify_reference_parity \
        --config kpvid_tpu_torch/configs/penn.yaml \
        --tf-checkpoint-stage1 /path/to/s1/model.ckpt-200000 \
        --tf-checkpoint-stage2 /path/to/s2/model.ckpt-100000 \
        [--reference-outputs /path/to/reference_eval_dir] \
        [--work-dir results/parity] [--batch-size 8] [--max-samples 64]

Counterpart of the JAX package's ``tools/verify_reference_parity.py``, on
the port: it imports both TF1 checkpoints (``import_tf1_checkpoint``, no
TensorFlow, ``--step 0``) into ``{work_dir}/{detector_translator,
motion_generator}/``, runs ``evaluate`` over the test split into
``{work_dir}/renders/``, and prints

1. PSNR(pred_seq vs real_seq) over the rendered samples (at most
   ``--max-samples``);
2. with ``--reference-outputs`` (a tree of renders laid out as evaluate
   writes them, ``{idx:04d}/pred_seq/{t:06d}.png``), each side's
   pred-vs-real PSNR over the samples both trees hold, and PASS when they
   are within ``--tolerance-db`` (0.1 dB) of each other, else FAIL and exit
   code 1.

It runs on the card by default (``--device cpu`` runs the plain versions on
the CPU). It keeps its own copies of the JAX tool's PSNR functions.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def _psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-12))


def pred_vs_real_psnr(root: Path, samples: list[Path]) -> tuple[float, int]:
    """Mean per-frame PSNR of {sample}/pred_seq/*.png against the matching
    real_seq frames under ``root`` (frames paired by name)."""
    from PIL import Image

    psnrs = []
    for s in samples:
        for pred_png in sorted((s / "pred_seq").glob("*.png")):
            real_png = root / s.name / "real_seq" / pred_png.name
            if not real_png.exists():
                continue
            psnrs.append(_psnr(np.asarray(Image.open(pred_png)), np.asarray(Image.open(real_png))))
    return float(np.mean(psnrs)), len(psnrs)


def compare_against_reference(eval_dir: Path, ref_root: Path, samples: list[Path],
                              tolerance_db: float) -> tuple[bool, float, float, float]:
    """(passed, ours_db, theirs_db, |delta|): each side's pred-vs-real PSNR
    (independent of the z draws), the real frames taken from our tree, both
    means over the same matched samples (a reference tree of some clips only
    must not weigh the verdict with those clips' difficulty)."""
    matched = [s for s in samples if (ref_root / s.name / "pred_seq").is_dir()]
    if not matched:
        raise SystemExit(f"--reference-outputs {ref_root} has no matching "
                         "{idx:04d}/pred_seq/*.png renders")
    ours, n_ours = pred_vs_real_psnr(eval_dir, matched)
    theirs, n_ref = pred_vs_real_psnr(eval_dir, [ref_root / s.name for s in matched])
    if not n_ours or not n_ref:
        raise SystemExit("no comparable frames found")
    delta = abs(ours - theirs)
    return delta <= tolerance_db, ours, theirs, delta


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="fidelity harness against reference TF1 checkpoints")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--tf-checkpoint-stage1", type=str, required=True)
    parser.add_argument("--tf-checkpoint-stage2", type=str, required=True)
    parser.add_argument("--reference-outputs", type=str, default=None,
                        help="dir of reference evaluate renders ({idx:04d}/pred_seq/*.png) "
                             "for the render-vs-render verdict")
    parser.add_argument("--work-dir", type=str, default="results/parity")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--max-samples", type=int, default=64,
                        help="cap on test samples compared")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tolerance-db", type=float, default=0.1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain versions")
    return parser


def main(argv=None) -> int:
    """Run the harness; returns the exit code (1 on FAIL)."""
    args = build_parser().parse_args(argv)
    from . import evaluate, import_tf1_checkpoint

    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)
    for stage, ckpt in ((1, args.tf_checkpoint_stage1), (2, args.tf_checkpoint_stage2)):
        import_tf1_checkpoint.main(["--config", args.config, "--stage", str(stage),
                                    "--tf-checkpoint", ckpt, "--log-dir", str(work),
                                    "--step", "0", "--device", args.device])
    eval_dir = work / "renders"
    evaluate.main(["--config", args.config,
                   "--checkpoint_stage1", str(work / "detector_translator"),
                   "--checkpoint_stage2", str(work / "motion_generator"),
                   "--save_dir", str(eval_dir), "--batch_size", str(args.batch_size),
                   "--seed", str(args.seed), "--device", args.device])

    samples = sorted(eval_dir.glob("[0-9]*"))[: args.max_samples]
    if not samples:
        raise SystemExit(f"no rendered samples under {eval_dir}")
    mean_psnr, n_frames = pred_vs_real_psnr(eval_dir, samples)
    print(f"\npred-vs-real PSNR over {len(samples)} samples ({n_frames} frames): "
          f"{mean_psnr:.3f} dB", flush=True)
    if not args.reference_outputs:
        print("\n(no --reference-outputs given: rerun with the reference's evaluate renders "
              "for the 0.1 dB verdict)", flush=True)
        return 0
    passed, ours, theirs, delta = compare_against_reference(
        eval_dir, Path(args.reference_outputs), samples, args.tolerance_db)
    print(f"matched-subset PSNR: ours {ours:.3f} dB, reference {theirs:.3f} dB", flush=True)
    print(f"\n{'PASS' if passed else 'FAIL'}: |ours - reference| = {delta:.3f} dB "
          f"(tolerance {args.tolerance_db} dB)", flush=True)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
