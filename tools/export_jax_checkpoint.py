#!/usr/bin/env python
"""Write a JAX trainer checkpoint from a trainer checkpoint of the PyTorch port.

    python tools/export_jax_checkpoint.py --config kpvid_tpu/configs/penn.yaml \
        --checkpoint results_torch/detector_translator --log-dir results/
    python tools/export_jax_checkpoint.py --config kpvid_tpu/configs/penn.yaml \
        --checkpoint results_torch/motion_generator/ckpt-20000 --log-dir results/

Run where JAX and Orbax are installed. ``--checkpoint`` is a port trainer
``ckpt-N`` directory (``python -m kpvid_tpu_torch.train`` or ``python -m
kpvid_tpu_torch.import_tf1_checkpoint``) or the directory that holds them
(the newest is taken); its stage is read off its names. The output is
``{log_dir}/{detector_translator|motion_generator}/ckpt-{N}`` (the port's
``N``), a ``GANTrainState`` saved with
``kpvid_tpu.utils.checkpoint.save_checkpoint``: root ``train.py`` resumes
it, and ``evaluate.py``, ``serve.py`` and ``make_pseudo_labels.py`` read it.
The template is the JAX trainer's own ``init_state`` (stage 1 with
synthesized VGG19 weights, which the state does not hold), so the tree, the
dtypes (the int32 step and counts among them) and optax's named tuples are
JAX's; every one of its leaves is replaced by the port's array
(``kpvid_tpu_torch.bridge.stage{1,2}_trainer_to_jax``), and a leaf the port
lacks, or one of another shape, is an error. This and
``tools/export_torch_params.py`` are the scripts outside the tests that
import both packages; neither package imports them.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def to_jax_state(config, arrays: dict):
    """The port trainer checkpoint ``arrays`` as the JAX trainer's
    ``GANTrainState`` for ``config``; returns (state, stage name)."""
    import jax

    from kpvid_tpu.utils.checkpoint import _key_name
    from kpvid_tpu_torch import bridge

    if any(k.startswith("stage1.") for k in arrays):
        from kpvid_tpu.losses import synthesize_vgg19_params
        from kpvid_tpu.train.stage1 import Stage1Trainer

        # the state holds no VGG weights: the narrowest tower builds fastest
        trainer = Stage1Trainer(config, synthesize_vgg19_params(max_width=8))
        fields, name = bridge.stage1_trainer_to_jax(arrays), "detector_translator"
    elif any(k.startswith("stage2.") for k in arrays):
        from kpvid_tpu.train.stage2 import Stage2Trainer

        trainer = Stage2Trainer(config)
        fields, name = bridge.stage2_trainer_to_jax(arrays), "motion_generator"
    else:
        raise ValueError("the checkpoint holds neither stage1.* nor stage2.* arrays")
    template = jax.eval_shape(trainer.init_state, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(fields)
    given = {tuple(_key_name(k) for k in path): leaf for path, leaf in flat}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out, wanted = [], set()
    for path, leaf in leaves:
        key = tuple(_key_name(k) for k in path)
        wanted.add(key)
        if key not in given:
            raise ValueError(f"the port's checkpoint lacks {'/'.join(key)}")
        val = np.asarray(given[key])
        if val.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {'/'.join(key)}: port {val.shape} vs JAX "
                             f"{tuple(leaf.shape)}")
        out.append(val.astype(leaf.dtype))
    extra = sorted("/".join(k) for k in set(given) - wanted)
    if extra:
        raise ValueError(f"the port's checkpoint has arrays JAX's state lacks: {extra[:5]}")
    return jax.tree_util.tree_unflatten(treedef, out), name


def main(argv=None) -> Path:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="the run's YAML config")
    parser.add_argument("--checkpoint", required=True,
                        help="a port trainer ckpt-N directory, or the directory that holds them")
    parser.add_argument("--log-dir", required=True,
                        help="writes {log_dir}/{detector_translator|motion_generator}/ckpt-N")
    args = parser.parse_args(argv)

    from kpvid_tpu.configs import load_config
    from kpvid_tpu.utils.checkpoint import save_checkpoint
    from kpvid_tpu_torch.checkpoint import load_checkpoint, resolve_parameter_file

    path = resolve_parameter_file(args.checkpoint)
    state, name = to_jax_state(load_config(args.config), load_checkpoint(path))
    # the directory's number, as the port named it (ckpt-N holds the state
    # after loop step N: its step is N + 1 but at the end of a run)
    out = save_checkpoint(args.log_dir, name, int(path.parent.name.split("-")[1]), state)
    print(f"wrote {out} from {path}")
    return out


if __name__ == "__main__":
    main()
