#!/usr/bin/env python
"""Write the PyTorch port's parameter file from a JAX checkpoint.

    python tools/export_torch_params.py --checkpoint results/detector_translator \
        --output stage1.npz
    python tools/export_torch_params.py --checkpoint results/motion_generator/ckpt-20000 \
        --output stage2.npz

Run where JAX and Orbax are installed. ``--checkpoint`` is a ``ckpt-N``
directory or its parent (the latest ``ckpt-N`` is taken). The checkpoint's
generator parameters and BN statistics go through
``kpvid_tpu_torch.bridge.from_jax``: a stage-1 checkpoint gives the
``stage1.*`` names (image encoder, pose encoder, translator), a stage-2
checkpoint the ``stage2.*`` names that generation reads. The output is the
``.npz`` of ``kpvid_tpu_torch.checkpoint.save_parameters``, which
``python -m kpvid_tpu_torch.serve`` and ``python -m
kpvid_tpu_torch.make_pseudo_labels`` take. This is the one script outside
the tests that imports both packages; neither package imports it.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> Path:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True,
                        help="a JAX ckpt-N directory, or the directory that holds them")
    parser.add_argument("--output", required=True, help="the .npz to write")
    args = parser.parse_args(argv)

    from kpvid_tpu.utils.checkpoint import latest_checkpoint, restore_checkpoint
    from kpvid_tpu_torch.bridge import from_jax
    from kpvid_tpu_torch.checkpoint import save_parameters

    ckpt = Path(args.checkpoint)
    if not ckpt.exists():
        raise FileNotFoundError(f"checkpoint not found at {ckpt}")
    if not ckpt.name.startswith("ckpt-"):
        resolved = latest_checkpoint(ckpt)
        if resolved is None:
            raise FileNotFoundError(f"no ckpt-N directories under {ckpt}")
        ckpt = resolved
    restored = restore_checkpoint(ckpt)
    g_params = restored.get("g_params", restored.get("params", {}))
    stage1 = {"params": g_params, "batch_stats": restored.get("batch_stats", {})}
    params = from_jax(stage1, g_params)
    if not params:
        raise ValueError(f"{ckpt} holds no stage-1 or stage-2 generator parameters")
    out = save_parameters(args.output, params)
    stages = sorted({name.split(".")[0] for name in params})
    print(f"wrote {len(params)} tensors ({', '.join(stages)}) from {ckpt} to {out}")
    return out


if __name__ == "__main__":
    main()
