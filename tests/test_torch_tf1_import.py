"""The port's TF1 checkpoint import against TensorFlow and against the JAX
package, on the CPU.

- ``utils/tf_bundle.py`` reads a bundle that ``tf.compat.v1.train.Saver``
  wrote (f32, f64, bf16, half, int32, int64, scalars; 1,407 tensors with
  long names, so that the index spans two of TensorFlow's 256 KB blocks,
  and one of 4.4 MB) to
  ``tf.train.load_checkpoint``'s bits (bf16 widened to f32, exact), and
  refuses a partitioned variable, a string tensor, a big-endian bundle and
  a tensor whose bytes fail their crc32c. ``chip_smoke.write_tf_bundle``
  (the writer the card's check uses) writes bundles that TensorFlow reads
  back to the same bits;
- ``utils/tf1_import.map_names`` names every tensor of the four trees as
  JAX's ``map_names`` does;
- ``python -m kpvid_tpu_torch.import_tf1_checkpoint`` with TensorFlow made
  unimportable, against root ``import_tf1_checkpoint.py``, on a TF-written
  reference bundle of random values under every TF1 name (and the Adam
  slots, beta powers and global step, which both skip): every mapped tensor
  matched, the port's checkpoint holds JAX's arrays bit for bit, ``generate``
  from the two imports agrees (images atol 1e-4, keypoints 1e-5, the bounds
  of tests/test_torch_final.py), and one stage-2 train step from ``--step
  7`` agrees (parameters atol 2e-6, or 2 lr where the first-step gradient is
  below 1e-6, tests/test_torch_train.py's bound), which holds only if the
  port takes a fresh optimizer's rate, ``lr(0)``, as optax does: the test's
  schedule decays 16% by step 7.

Smoke widths as tests/test_torch_stage1.py and test_torch_train.py.
"""

import hashlib
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import tensorflow as tf
import torch

import jax

from kpvid_tpu.configs import load_config as jax_load_config
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator
from kpvid_tpu.losses import synthesize_vgg19_params as jax_synthesize_vgg19_params
from kpvid_tpu.train.stage1 import Stage1Trainer as JaxStage1Trainer
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer
from kpvid_tpu.utils.checkpoint import _key_name, merge_restore, restore_checkpoint
from kpvid_tpu.utils.tf1_import import map_names as jax_map_names
from kpvid_tpu_torch import bridge
from kpvid_tpu_torch import configs as tcfgs
from kpvid_tpu_torch.checkpoint import load_checkpoint
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.serve import load_generator_parameters
from kpvid_tpu_torch.train import Stage2Trainer
from kpvid_tpu_torch.utils.tf1_import import STAGES, map_names
from kpvid_tpu_torch.utils.tf_bundle import TFBundle, crc32c

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import write_tf_bundle  # noqa: E402

N_SMALL = 1400
LR = 1e-4
PARAM_ATOL = 2e-6
YAML = """
paths: {{log_dir: '{log}'}}
training: {{compute_dtype: float32, batch_size: 2, lr: {{step: 2}}}}
model: {{n_pts: 4, n_action: 3, cell_info: [32, 32], vae_dim: 8, n_future_frames: 8,
         image_size: 32, heatmap_size: 8, encoder_filters: 8, translator_filters: 16,
         pose_decoder_filters: 16, discriminator_filters: 8}}
"""


def _tf_save(prefix: Path, values: dict) -> None:
    """A bundle of ``values`` (name -> numpy array or tf tensor) written by
    TensorFlow's V1 Saver, the writer of the reference's checkpoints."""
    tf_vars = {name: tf.Variable(val, name=f"v{i}") for i, (name, val) in
               enumerate(sorted(values.items()))}
    tf.compat.v1.train.Saver(var_list=tf_vars).save(None, str(prefix), write_meta_graph=False)


# ------------------------------------------------------------ the reader
def _reader_values() -> dict:
    rng = np.random.default_rng(0)
    # long keys that part early, so that prefix compression keeps them long
    # and TensorFlow's index outgrows one 256 KB block
    values = {f"{hashlib.sha1(str(i).encode()).hexdigest()}/{'layer/' * 30}conv2d/kernel":
              rng.normal(size=(3, 3, 2, i % 5 + 1)).astype(np.float32) for i in range(N_SMALL)}
    values.update({
        "big": rng.normal(size=(1100, 1000)).astype(np.float32),
        "f64": rng.normal(size=(5, 3)),
        "half": rng.normal(size=(2, 3)).astype(np.float16),
        "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
        "global_step": np.asarray(200000, np.int64),
        "scalar": np.asarray(1.5, np.float32),
        "bf16": tf.constant(rng.normal(size=(3, 5)).astype(np.float32), dtype=tf.bfloat16),
    })
    return values


@pytest.fixture(scope="module")
def tf_bundle(tmp_path_factory):
    prefix = tmp_path_factory.mktemp("tfbundle") / "ref.ckpt"
    _tf_save(prefix, _reader_values())
    return prefix


GROUPS = {"f32": "/conv2d/kernel", "big": "big", "f64": "f64", "half": "half", "int32": "i32",
          "int64": "global_step", "scalar": "scalar", "bf16": "bf16"}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_reader_gives_tensorflows_bits(tf_bundle, group):
    """Each dtype and shape as tf.train.load_checkpoint reads it, bit for bit."""
    want_reader = tf.train.load_checkpoint(str(tf_bundle))
    got_bundle = TFBundle(tf_bundle)
    assert got_bundle.shapes() == {k: tuple(v) for k, v in
                                   want_reader.get_variable_to_shape_map().items()}
    names = [n for n in got_bundle.shapes() if n == GROUPS[group] or n.endswith(GROUPS[group])]
    assert names
    for name in names:
        want, got = want_reader.get_tensor(name), got_bundle.tensor(name)
        if group == "bf16":  # widened to f32: the same bits in the high half
            assert got.dtype == np.float32
            assert np.array_equal((got.view(np.uint32) >> 16).astype(np.uint16),
                                  np.asarray(want).view(np.uint16))
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == np.asarray(want).tobytes(), name
    if group == "big":
        assert got.nbytes >= 4 * 2**20


def test_bundle_index_spans_several_blocks(tf_bundle):
    """TensorFlow's index of the bundle above has more than one data block,
    and the reader lists the tensors of all of them."""
    from kpvid_tpu_torch.utils import tf_bundle as tb

    data = Path(str(tf_bundle) + ".index").read_bytes()
    footer = data[-tb.FOOTER_BYTES:]
    _, pos = tb._varint(footer, 0)
    _, pos = tb._varint(footer, pos)
    index = list(tb._block_entries(tb._read_block(data, footer[pos:])))
    assert len(index) > 1
    assert len(TFBundle(tf_bundle).shapes()) == N_SMALL + 7


def test_crc32c_chunked_path_matches_bytewise():
    """crc32c's chunked path for long inputs gives the byte-by-byte
    register's value (TensorFlow's stored checksums hold both on the
    bundles above)."""
    from kpvid_tpu_torch.utils.tf_bundle import _crc_update

    assert crc32c(b"123456789") == 0xE3069283  # the standard check value
    rng = np.random.default_rng(1)
    for n in (0, 1, 4095, 4096, 70001, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == _crc_update(0xFFFFFFFF, data) ^ 0xFFFFFFFF, n


def test_writer_reads_back_through_tensorflow(tmp_path):
    values = {k: v for k, v in _reader_values().items() if k != "bf16"}
    n_bytes = write_tf_bundle(tmp_path / "w", values)
    assert n_bytes > sum(v.nbytes for v in values.values())
    reader = tf.train.load_checkpoint(str(tmp_path / "w"))
    assert sorted(reader.get_variable_to_shape_map()) == sorted(values)
    for name, val in values.items():
        got = reader.get_tensor(name)
        assert got.dtype == val.dtype and got.shape == val.shape
        assert got.tobytes() == val.tobytes(), name


def test_reader_refuses_a_partitioned_variable(tmp_path):
    with tf.Graph().as_default():
        tf.compat.v1.get_variable(
            "part", shape=[8, 4], partitioner=tf.compat.v1.fixed_size_partitioner(2))
        tf.compat.v1.get_variable("whole", shape=[3])
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(tmp_path / "p.ckpt"), write_meta_graph=False)
    bundle = TFBundle(tmp_path / "p.ckpt")
    assert bundle.shapes()["part"] == (8, 4)
    assert bundle.tensor("whole").shape == (3,)
    with pytest.raises(ValueError, match="partitioned variable"):
        bundle.tensor("part")


def test_reader_refuses_strings_big_endian_and_corruption(tmp_path):
    _tf_save(tmp_path / "s.ckpt", {"s": tf.constant(["ab", "c"]), "x": np.ones(2, np.float32)})
    with pytest.raises(ValueError, match="string tensor"):
        TFBundle(tmp_path / "s.ckpt").tensor("s")
    write_tf_bundle(tmp_path / "be", {"x": np.ones(2, np.float32)}, big_endian=True)
    with pytest.raises(ValueError, match="big-endian"):
        TFBundle(tmp_path / "be")
    write_tf_bundle(tmp_path / "c", {"x": np.arange(64, dtype=np.float32)})
    data = tmp_path / "c.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[9] ^= 1
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum mismatch"):
        TFBundle(tmp_path / "c").tensor("x")


# -------------------------------------------------------------- the names
def _config(root: Path):
    path = root / "cfg.yaml"
    path.write_text(YAML.format(log=root / "log"))
    return path


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """JAX's initial trainer states at smoke widths, both stages."""
    cfg = jax_load_config(_config(tmp_path_factory.mktemp("cfg")))
    s1 = JaxStage1Trainer(cfg, jax_synthesize_vgg19_params(max_width=16))
    return {1: jax.device_get(s1.init_state(jax.random.PRNGKey(0))),
            2: jax.device_get(JaxStage2Trainer(cfg).init_state(jax.random.PRNGKey(0)))}


def _port_names(state, stage: int) -> dict:
    """JAX path -> the port's trainer name, through the bridge."""
    fwd = (bridge.stage1_trainer_from_jax(state.g_params, state.d_params, state.batch_stats)
           if stage == 1 else bridge.stage2_trainer_from_jax(state.g_params, state.d_params))
    return {name: bridge.jax_path(name.split(".", 1)[1]) for name in fwd}


@pytest.mark.parametrize("stage", STAGES)
def test_name_map_equals_jaxs(jax_states, stage):
    """For every tensor of the stage's tree, the port's TF1 name is JAX's."""
    n = 1 if stage.startswith("stage1") else 2
    state = jax_states[n]
    with_stats = stage == "stage1"
    tree = (state.d_params if stage.endswith("_discr") else
            {"params": state.g_params, "batch_stats": state.batch_stats} if with_stats
            else state.g_params)
    want = jax_map_names(tree, stage)
    if with_stats:  # drop the params / batch_stats level: the port's names have none
        want = {k[1:]: v for k, v in want.items()}
    prefix = {"stage1": "stage1.", "stage1_discr": "image_discriminator.",
              "stage2": "stage2.", "stage2_discr": "discriminator."}[stage]
    names = {k: p for k, p in _port_names(state, n).items() if k.startswith(prefix)}
    got = map_names(names, stage)
    assert len(got) == len(want) == len(names) > 0
    assert {names[k]: v for k, v in got.items()} == want


# ------------------------------------------------------- the CLIs, both ways
def _reference_bundle(root: Path, stage: int, state) -> Path:
    """A TF-written bundle under the reference's TF1 names, random values,
    with the Adam slots, beta powers and global step a TF1 run saves too."""
    rng = np.random.default_rng(10 + stage)
    values = {}
    for part in ("", "_discr"):
        tree = state.d_params if part else (
            {"params": state.g_params, "batch_stats": state.batch_stats} if stage == 1
            else state.g_params)
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        shapes = {tuple(_key_name(k) for k in p): np.shape(v) for p, v in flat}
        for path, tf_name in jax_map_names(tree, f"stage{stage}{part}").items():
            shape = shapes[path]
            val = rng.normal(0, 0.2, shape).astype(np.float32)
            if tf_name.endswith("moving_variance"):
                val = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            values[tf_name] = val
            values[tf_name + "/Adam"] = np.zeros(shape, np.float32)
            values[tf_name + "/Adam_1"] = np.zeros(shape, np.float32)
    values.update({"beta1_power": np.float32(0.5), "beta2_power": np.float32(0.999),
                   "global_step": np.asarray(200000, np.int64)})
    prefix = root / f"model{stage}.ckpt-200000"
    _tf_save(prefix, values)
    return prefix


@pytest.fixture(scope="module")
def imported(tmp_path_factory, jax_states):
    """Both stages' reference bundles imported by root import_tf1_checkpoint.py
    (JAX, TensorFlow) and by the port's CLI with TensorFlow unimportable,
    both at --step 7."""
    import import_tf1_checkpoint as jax_cli

    from kpvid_tpu_torch import import_tf1_checkpoint

    root = tmp_path_factory.mktemp("import")
    cfg = _config(root)
    out = {"root": root, "cfg": cfg}
    for stage in (1, 2):
        ref = _reference_bundle(root, stage, jax_states[stage])
        args = ["--config", str(cfg), "--stage", str(stage), "--tf-checkpoint", str(ref),
                "--step", "7"]
        with mock.patch.object(sys, "argv", ["import_tf1_checkpoint.py"] + args
                               + ["--log-dir", str(root / "jax")]):
            jax_cli.main()
        # TensorFlow unimportable for the port's run (only this one key of
        # sys.modules is swapped and put back: the modules the run imports stay)
        saved = sys.modules["tensorflow"]
        sys.modules["tensorflow"] = None
        try:
            with pytest.raises(ImportError):
                import tensorflow  # noqa: F401
            out[stage] = import_tf1_checkpoint.main(args + ["--log-dir", str(root / "port"),
                                                            "--device", "cpu"])
        finally:
            sys.modules["tensorflow"] = saved
    return out


@pytest.mark.parametrize("stage", [1, 2])
def test_import_cli_matches_jaxs(imported, stage):
    """Every mapped tensor matched, none missing or mismatched; the port's
    ckpt-7 holds JAX's imported arrays bit for bit, a fresh Adam state and
    step 7."""
    rep = imported[stage]
    for part in ("generator", "discriminator"):
        assert rep[part]["matched"] and not rep[part]["missing"] and not rep[part]["mismatched"]
    name = "detector_translator" if stage == 1 else "motion_generator"
    assert rep["path"] == (imported["root"] / "port" / name / "ckpt-7").resolve()
    arrays = load_checkpoint(rep["path"])
    restored = restore_checkpoint(imported["root"] / "jax" / name / "ckpt-7")
    fields = (bridge.stage1_trainer_to_jax if stage == 1 else bridge.stage2_trainer_to_jax)(arrays)
    assert int(arrays["step"]) == int(restored["step"]) == 7
    for key in ("g_params", "d_params", "batch_stats"):
        want = {tuple(_key_name(k) for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(restored[key])[0]}
        got = {tuple(_key_name(k) for k in p): v for p, v in
               jax.tree_util.tree_flatten_with_path(fields[key])[0]}
        assert sorted(got) == sorted(want), key
        for path in want:
            assert np.array_equal(got[path], want[path]), (key, path)
    moments = [v for k, v in arrays.items() if k.endswith(("exp_avg", "exp_avg_sq"))]
    steps = [v for k, v in arrays.items() if k.endswith(".step")]
    assert moments and not any(m.any() for m in moments) and not any(s.any() for s in steps)


def test_generate_from_the_imports_matches_jax(imported):
    """FinalGenerator on the two port imports against JAX's generate on the
    two JAX imports, f32, the same z."""
    root = imported["root"]
    tcfg = tcfgs.load_config(imported["cfg"])
    gen = FinalGenerator(tcfg, device="cpu")
    gen.load_parameters(load_generator_parameters(
        gen.model.state_dict(), str(root / "port" / "detector_translator"),
        str(root / "port" / "motion_generator")))
    s1 = restore_checkpoint(root / "jax" / "detector_translator" / "ckpt-7")
    s2 = restore_checkpoint(root / "jax" / "motion_generator" / "ckpt-7")
    jgen = JaxFinalGenerator(jax_load_config(imported["cfg"]))
    rng = np.random.default_rng(3)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(3, dtype=np.float32)[[0, 2]]
    z = rng.standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda a, b, c, d, e: jgen.generate(a, b, c, d, None, z=e))(
        {"params": s1["g_params"], "batch_stats": s1["batch_stats"]}, s2["g_params"], im, act, z)
    got = gen.generate(im, act, z)
    for key, atol in (("current_points", 1e-5), ("future_points", 1e-5), ("pred_im_seq", 1e-4),
                      ("mask", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol,
                                   err_msg=key)


def test_first_step_after_import_matches_jax(imported):
    """One fused stage-2 step from each import's ckpt-7 on the same batch
    and noise: the port takes lr(0), as optax's fresh count does (lr(7) is
    16% lower under this schedule), and the parameters agree."""
    root = imported["root"]
    jcfg = jax_load_config(imported["cfg"])
    jt = JaxStage2Trainer(jcfg)
    state, n = merge_restore(jt.init_state(jax.random.PRNGKey(1)),
                             restore_checkpoint(root / "jax" / "motion_generator" / "ckpt-7"))
    assert n > 0 and int(state.step) == 7
    rng = np.random.default_rng(5)
    start = rng.uniform(-0.6, 0.6, (2, 1, 4, 2))
    seq = np.clip(start + rng.normal(0, 0.05, (2, 9, 4, 2)).cumsum(axis=1), -1, 1)
    batch = {"keypoints": seq[:, 0].astype(np.float32), "real_seq": seq[:, 1:].astype(np.float32),
             "action_code": np.eye(3, dtype=np.float32)[[1, 2]]}
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (2, 8), jax.numpy.float32))
    want_state, want_metrics = jax.jit(jt.train_step)(state, batch, key)
    want_state = jax.device_get(want_state)

    trainer = Stage2Trainer(tcfgs.load_config(imported["cfg"]), device="cpu")
    trainer.load_state_arrays(load_checkpoint(root / "port" / "motion_generator" / "ckpt-7"))
    first_grads = {}
    apply = trainer._apply

    def recording_apply(opt, params, grads):
        for p, g in zip(params, grads):
            first_grads[id(p)] = g.clone()
        apply(opt, params, grads)
        first_grads.setdefault("lr", opt.param_groups[0]["lr"])

    trainer._apply = recording_apply
    metrics = trainer.train_step(batch, noise)
    assert first_grads["lr"] == trainer.lr_schedule(0) != trainer.lr_schedule(7)
    assert trainer.lr_schedule(7) < 0.9 * trainer.lr_schedule(0)
    assert trainer.step == int(want_state.step) == 8
    np.testing.assert_allclose(float(metrics["lr"]), float(want_metrics["lr"]), rtol=1e-6)
    want = bridge.stage2_trainer_from_jax(want_state.g_params, want_state.d_params)
    for name, p in trainer.model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        bound = torch.where(first_grads[id(p)].abs() < 1e-6, torch.full_like(diff, 2 * LR),
                            torch.full_like(diff, PARAM_ATOL))
        assert bool((diff <= bound).all()), (name, float(diff.max()))


def test_import_refuses_a_checkpoint_of_the_other_stage(imported, tmp_path):
    """No generator tensor matched: JAX's SystemExit."""
    from kpvid_tpu_torch import import_tf1_checkpoint

    ref = next(imported["root"].glob("model2.ckpt-200000.index"))
    with pytest.raises(SystemExit, match="no generator tensors matched"):
        import_tf1_checkpoint.main(["--config", str(imported["cfg"]), "--stage", "1",
                                    "--tf-checkpoint", str(ref)[:-len(".index")],
                                    "--log-dir", str(tmp_path), "--device", "cpu"])

