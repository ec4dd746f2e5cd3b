"""The port's parameter file, its merge, the JAX-checkpoint converter, and
the package's import boundary, on the CPU.

- ``save_parameters`` / ``load_parameters``: an .npz round trip, exact, read
  without pickle;
- ``merge_parameters``: the name-intersection semantics of
  kpvid_tpu/utils/checkpoint.py::merge_restore, its match count, and its
  refusals (0 names matched, a shape mismatch);
- ``tools/export_torch_params.py`` on Orbax checkpoints written by
  ``kpvid_tpu.utils.checkpoint.save_checkpoint``: the port's ``generate`` on
  the two files it writes matches the JAX package's at f32 (points atol
  1e-5, images atol 1e-4, the bounds of tests/test_torch_final.py);
- no module of kpvid_tpu_torch imports JAX or kpvid_tpu, and the converter
  is the one file outside the tests that imports both packages.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from kpvid_tpu.configs import Config, ModelConfig, TrainingConfig
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator
from kpvid_tpu.utils.checkpoint import save_checkpoint
from kpvid_tpu_torch.checkpoint import load_parameters, merge_parameters, save_parameters
from kpvid_tpu_torch.configs import Config as TConfig
from kpvid_tpu_torch.configs import ModelConfig as TModelConfig
from kpvid_tpu_torch.configs import TrainingConfig as TTrainingConfig
from kpvid_tpu_torch.eval import FinalGenerator
from test_torch_final import SMOKE

REPO = Path(__file__).resolve().parent.parent


def test_parameter_file_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"stage1.a.conv.weight": torch.randn(4, 3, 3, 3, generator=g),
              "stage2.dec_lstm.lstm_0_bias": torch.randn(8, generator=g),
              "stage1.a.bn.running_var": np.linspace(0.5, 2.0, 4, dtype=np.float32)}
    path = save_parameters(tmp_path / "sub" / "p.npz", params)
    with np.load(path, allow_pickle=False) as data:
        assert sorted(data.files) == sorted(params)
    got = load_parameters(path)
    assert sorted(got) == sorted(params)
    for name, val in params.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], torch.as_tensor(val))


def test_merge_parameters_by_name():
    target = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.ones(1)}
    source = {"a": torch.full((2, 3), 2.0), "b": np.arange(4, dtype=np.float64), "x": torch.ones(5)}
    merged, n = merge_parameters(target, source)
    assert n == 2 and sorted(merged) == ["a", "b", "c"]
    assert torch.equal(merged["a"], source["a"]) and torch.equal(merged["c"], target["c"])
    assert merged["b"].dtype == torch.float32 and merged["b"].tolist() == [0, 1, 2, 3]
    assert torch.equal(target["a"], torch.zeros(2, 3))  # the target is not written
    with pytest.raises(ValueError, match="matched 0"):
        merge_parameters(target, {"x": torch.ones(5)})
    with pytest.raises(ValueError, match="shape mismatch at b"):
        merge_parameters(target, {"b": torch.zeros(5)})


def test_export_tool_from_orbax_matches_jax_generate(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import export_torch_params
    finally:
        sys.path.remove(str(REPO / "tools"))

    cfg = Config(model=ModelConfig(**SMOKE),
                 training=TrainingConfig(batch_size=2, compute_dtype="float32")).validate()
    jgen = JaxFinalGenerator(cfg)
    s1, s2 = jgen.init_variables(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    noisy = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.05, np.shape(a)).astype(np.float32),
        tree)
    s1 = {"params": noisy(s1["params"]), "batch_stats": jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), s1["batch_stats"])}
    s2p = noisy(s2["params"])
    extra = {"kernel": np.ones((2, 2), np.float32)}  # a discriminator, not read
    save_checkpoint(tmp_path, "stage1", 3, {"g_params": s1["params"], "d_params": extra,
                                            "batch_stats": s1["batch_stats"]})
    save_checkpoint(tmp_path, "stage2", 5, {"g_params": s2p, "d_params": extra})
    out1 = export_torch_params.main(["--checkpoint", str(tmp_path / "stage1"),
                                     "--output", str(tmp_path / "s1.npz")])
    out2 = export_torch_params.main(["--checkpoint", str(tmp_path / "stage2" / "ckpt-5"),
                                     "--output", str(tmp_path / "s2.npz")])
    p1, p2 = load_parameters(out1), load_parameters(out2)
    assert p1 and all(k.startswith("stage1.") for k in p1)
    assert p2 and all(k.startswith("stage2.") for k in p2)

    tcfg = TConfig(model=TModelConfig(**SMOKE), training=TTrainingConfig("float32")).validate()
    gen = FinalGenerator(tcfg, device="cpu")
    params, n1 = merge_parameters(gen.model.state_dict(), p1)
    params, n2 = merge_parameters(params, p2)
    assert n1 + n2 == len(params)  # every tensor of the model came from a file
    gen.load_parameters(params)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[[0, 4]]
    z = rng.standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda a, b, c, d, e: jgen.generate(a, b, c, d, None, z=e))(s1, s2p, im, act, z)
    got = gen.generate(im, act, z)
    for key, atol in (("current_points", 1e-5), ("future_points", 1e-5), ("pred_im_seq", 1e-4),
                      ("mask", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol,
                                   err_msg=key)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _roots(names: set[str]) -> set[str]:
    return {n.split(".")[0] for n in names}


def test_package_imports_neither_jax_nor_kpvid_tpu():
    """Every module of kpvid_tpu_torch, and chip_smoke.py: no import of JAX,
    Flax, Orbax or kpvid_tpu. Outside tests/, the converter is the one file
    that imports both packages."""
    banned = {"jax", "jaxlib", "flax", "orbax", "optax", "kpvid_tpu"}
    modules = sorted((REPO / "kpvid_tpu_torch").rglob("*.py"))
    assert len(modules) >= 40
    for new in ("losses/perceptual.py", "train/stage1.py", "data/image_pair.py"):
        assert REPO / "kpvid_tpu_torch" / new in modules
    for path in modules + [REPO / "chip_smoke.py"]:
        assert not _roots(_imports(path)) & banned, path
    scripts = sorted(REPO.glob("*.py")) + sorted((REPO / "tools").glob("*.py")) + modules
    both = [p.relative_to(REPO).as_posix() for p in scripts
            if {"kpvid_tpu", "kpvid_tpu_torch"} <= _roots(_imports(p))]
    assert both == ["tools/export_torch_params.py"]
