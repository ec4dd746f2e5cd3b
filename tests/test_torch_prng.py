"""kpvid_tpu_torch/utils/jax_random.py against jax.random and Flax's init, on the CPU.

- keys (``PRNGKey`` of seeds 0, 3, 7, -1, 2**32 + 5 and 2**63 - 1), ``split``
  (n = 2, 3, 7), ``fold_in`` (data 0, 1, 2**31, 2**32 - 1), ``bits`` and
  ``uniform`` at shapes (), (1,), (3, 64), (1000, 64) and (37, 13): bit for
  bit; ``normal``: within 4 ulp, with at least 90% of the draws equal
  (``erfinv`` is XLA's polynomial, its ``log1p`` numpy's);
- Random123's threefry2x32_20 vectors, through the port and through JAX;
- each smoke-width leaf of ``FinalGenerator.init_parameters(s)`` and of
  both trainers' ``init_parameters(s)`` against JAX's ``init_variables`` /
  ``init_state`` of ``PRNGKey(s)`` for s = 0 and 3 (and of the train CLI's
  init key): Xavier, zero and one leaves bit for bit, the normal(0.02)
  head within 4 ulp;
- the answer file ``tests/data/jax_random_kat.json`` that chip_smoke.py's
  phase 15 reads on the card's machine (which has no JAX) against JAX:
  :func:`jax_answers` computes it (the full-width trees once per module),
  and ``python tests/test_torch_prng.py`` rewrites it.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from kpvid_tpu.configs import Config, ModelConfig, TrainingConfig  # noqa: E402
from kpvid_tpu.eval import FinalGenerator as JaxFinalGenerator  # noqa: E402
from kpvid_tpu.losses import synthesize_vgg19_params as jax_vgg  # noqa: E402
from kpvid_tpu.train.stage1 import Stage1Trainer as JaxStage1Trainer  # noqa: E402
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer  # noqa: E402
from kpvid_tpu_torch import bridge  # noqa: E402
from kpvid_tpu_torch import configs as tcfgs  # noqa: E402
from kpvid_tpu_torch.utils import jax_random as jr  # noqa: E402

KAT = REPO / "tests" / "data" / "jax_random_kat.json"
SEEDS = [0, 3, 7, -1, 2**32 + 5, 2**63 - 1]
SHAPES = [(), (1,), (3, 64), (1000, 64), (37, 13)]
SPLITS = [2, 3, 7]
DATA = [0, 1, 2**31, 2**32 - 1]
MAX_ULP = 4
MIN_EQUAL = 0.9
# the answer file's draws: small shapes with every normal's value
KAT_SHAPES = [(), (1,), (3, 64), (37, 13), (1024,)]
SMOKE = dict(n_pts=4, n_action=5, cell_info=(16, 16), vae_dim=8, image_size=32, heatmap_size=8,
             n_future_frames=6, encoder_filters=8, translator_filters=16, pose_decoder_filters=16,
             discriminator_filters=8)
NORMAL_LEAVES = ("to_coord.weight",)  # normal(0.02); every other drawn leaf is Xavier


def jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_ins_equal_jax(seed):
    key = jr.PRNGKey(seed)
    assert key.dtype == np.uint32 and key.tolist() == jkey(seed).tolist()
    for n in SPLITS:
        assert np.array_equal(jr.split(key, n), np.asarray(jax.random.split(key, n))), n
    for d in DATA:
        assert np.array_equal(jr.fold_in(key, d), np.asarray(jax.random.fold_in(key, d))), d


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_equal_jax(seed, shape):
    key = jr.PRNGKey(seed)
    assert np.array_equal(jr.bits(key, shape), np.asarray(jax.random.bits(key, shape)))
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-3.0, 2.5)):
        got = jr.uniform(key, shape, np.float32, lo, hi)
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), (lo, hi)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_4_ulp_of_jax(seed, shape):
    key = jr.PRNGKey(seed)
    got = jr.normal(key, shape)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    assert got.shape == want.shape and got.dtype == want.dtype
    d = chip_smoke.ulps(got, want)
    assert int(d.max(initial=0)) <= MAX_ULP
    if d.size >= 1000:
        assert (d == 0).mean() >= MIN_EQUAL, (d == 0).mean()


def test_erfinv_is_xlas():
    """Both branches of the polynomial, the split at w = 5 and the edges."""
    x = np.concatenate([np.linspace(-1, 1, 20001, dtype=np.float32),
                        np.float32(1) - np.float32(2.0**-24) * np.arange(1, 64, dtype=np.float32),
                        np.float32([0.0, -0.0, 0.99, -0.9966])])
    got = jr.erfinv(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite) and np.array_equal(got[~finite], want[~finite])
    assert int(chip_smoke.ulps(got[finite], want[finite]).max()) <= MAX_ULP


def test_random123_vectors():
    from jax._src import prng

    for key, ctr, want in chip_smoke.RANDOM123_KAT:
        y0, y1 = jr.threefry2x32(np.array(key, np.uint32), np.array([ctr[0]], np.uint32),
                                 np.array([ctr[1]], np.uint32))
        assert (int(y0[0]), int(y1[0])) == want
        jy = prng.threefry_2x32(jnp.asarray(key, jnp.uint32), jnp.asarray(ctr, jnp.uint32))
        assert tuple(int(v) for v in np.asarray(jy)) == want


def test_flax_param_keys():
    """Each parameter of a Flax module is drawn with the key of its scope
    path and its place among the scope's parameters."""
    from flax import linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dense(3, kernel_init=nn.initializers.xavier_uniform(), name="first")(x)
            return nn.Dense(2, kernel_init=nn.initializers.normal(0.02))(x)

    root = jr.PRNGKey(11)
    tree = jax.jit(Net().init)(root, jnp.zeros((1, 5)))["params"]
    want = jr.xavier_uniform(jr.flax_param_key(root, ("first",), 1), (5, 3))
    assert np.asarray(tree["first"]["kernel"]).tobytes() == want.tobytes()
    want = jr.normal_init(jr.flax_param_key(root, ("Dense_0",), 1), (3, 2))
    assert int(chip_smoke.ulps(np.asarray(tree["Dense_0"]["kernel"]), want).max()) <= MAX_ULP
    assert not jr.flax_param_key(root, ("first",), 2).tolist() == jr.flax_param_key(
        root, ("first",), 1).tolist()


def test_xavier_uniform_is_flaxs():
    from flax import linen as nn

    for i, shape in enumerate([(7, 5), (3, 3, 4, 6), (1, 1, 16, 2), (1024 + 40, 4096)]):
        key = jr.PRNGKey(i)
        want = np.asarray(nn.initializers.xavier_uniform()(key, shape, jnp.float32))
        assert jr.xavier_uniform(key, shape).tobytes() == want.tobytes(), shape


# ------------------------------------------------------------ the trees
def jax_config(**training):
    return Config(model=ModelConfig(**SMOKE),
                  training=TrainingConfig(batch_size=2, compute_dtype="float32", **training)
                  ).validate()


def port_config():
    return tcfgs.Config(model=tcfgs.ModelConfig(**SMOKE),
                        training=tcfgs.TrainingConfig("float32", batch_size=2)).validate()


def assert_leaves_equal(got: dict, want: dict) -> None:
    """Every leaf: bit for bit, the normal(0.02) head within 4 ulp."""
    assert sorted(got) == sorted(want)
    for name, val in want.items():
        g = got[name].numpy()
        assert g.shape == tuple(val.shape) and g.dtype == np.float32, name
        if name.endswith(NORMAL_LEAVES):
            assert int(chip_smoke.ulps(g, val.numpy()).max()) <= MAX_ULP, name
        else:
            assert g.tobytes() == val.numpy().tobytes(), name


def jax_final_tree(cfg, key) -> dict:
    s1, s2 = JaxFinalGenerator(cfg).init_variables(key)
    return {**bridge.from_jax(s1, None), **bridge.stage2_trainer_from_jax(s2["params"], {})}


def jax_trainer_tree(stage: int, cfg, key) -> dict:
    if stage == 1:
        st = JaxStage1Trainer(cfg, jax_vgg(max_width=16)).init_state(key)
        return bridge.stage1_trainer_from_jax(st.g_params, st.d_params, st.batch_stats)
    st = JaxStage2Trainer(cfg).init_state(key)
    return bridge.stage2_trainer_from_jax(st.g_params, st.d_params)


@pytest.mark.parametrize("seed", [0, 3])
def test_final_generator_init_is_jaxs(seed):
    from kpvid_tpu_torch.eval import FinalGenerator

    got = FinalGenerator(port_config(), device="cpu").init_parameters(seed)
    want = jax_final_tree(jax_config(), jax.random.PRNGKey(seed))
    # the port's generator holds the stage-2 decoder only
    want = {k: v for k, v in want.items() if not k.startswith(("stage2.enc_"))}
    assert_leaves_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, "cli"])
@pytest.mark.parametrize("stage", [1, 2])
def test_trainer_init_is_jaxs(stage, seed):
    """init_parameters(s) is init_state(PRNGKey(s)); "cli": the train CLI's
    init key for training.seed 5, split(PRNGKey(5))[1], as JAX's train.py."""
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer
    from kpvid_tpu_torch.train.cli import init_key

    key = init_key(5) if seed == "cli" else jr.PRNGKey(seed)
    if seed == "cli":
        assert key.tolist() == np.asarray(jax.random.split(jax.random.PRNGKey(5))[1]).tolist()
    trainer = (Stage1Trainer(port_config(), synthesize_vgg19_params(max_width=16), device="cpu")
               if stage == 1 else Stage2Trainer(port_config(), device="cpu"))
    got = trainer.init_parameters(seed if isinstance(seed, int) else key)
    assert_leaves_equal(got, jax_trainer_tree(stage, jax_config(), key))


# ----------------------------------------------------------- the answer file
def jax_answers() -> dict:
    """Everything phase 15 holds the port to, computed with JAX."""
    from kpvid_tpu_torch import evaluate

    seeds = []
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        draws = []
        for shape in KAT_SHAPES:
            draws.append({
                "shape": list(shape),
                "bits": chip_smoke.digest(np.asarray(jax.random.bits(key, shape))),
                "uniform": chip_smoke.digest(np.asarray(jax.random.uniform(key, shape))),
                "uniform_affine": chip_smoke.digest(np.asarray(
                    jax.random.uniform(key, shape, jnp.float32, -3.0, 2.5))),
                "normal": np.asarray(jax.random.normal(key, shape)).reshape(-1).tolist()})
        seeds.append({
            "seed": seed, "key": np.asarray(key).tolist(),
            "split": {str(n): np.asarray(jax.random.split(key, n)).tolist() for n in SPLITS},
            "fold_in": {str(d): np.asarray(jax.random.fold_in(key, d)).tolist() for d in DATA},
            "draws": draws})
    z_rows, vae_dim = 4, Config().model.vae_dim
    batches = [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(3), b),
                                            (z_rows, vae_dim))).tolist() for b in range(2)]
    assert evaluate.batch_z(3, 0, z_rows, vae_dim).shape == (z_rows, vae_dim)
    cfg = Config().validate()
    init_key = jax.random.split(jax.random.PRNGKey(cfg.training.seed))[1]  # train.py's
    trees = {}
    for name, key, tree in (
            ("final_generator", jax.random.PRNGKey(0),
             lambda k: jax_final_tree(cfg, k)),
            ("stage1_trainer", init_key, lambda k: jax_trainer_tree(1, cfg, k)),
            ("stage2_trainer", init_key, lambda k: jax_trainer_tree(2, cfg, k))):
        leaves = tree(key)
        trees[name] = {"key": np.asarray(key).tolist(),
                       "sums": {leaf: chip_smoke.leaf_sum(bridge.to_flax_layout(v))
                                for leaf, v in sorted(leaves.items())}}
        del leaves
    return {"jax": jax.__version__, "seeds": seeds,
            "evaluate_z": {"seed": 3, "rows": z_rows, "vae_dim": vae_dim, "batches": batches},
            "trees": trees}


@pytest.fixture(scope="module")
def answers():
    return jax_answers()


def test_answer_file_is_jaxs(answers):
    """The committed file holds exactly what JAX computes now (JSON floats
    round-trip f32 and f64 values exactly)."""
    stored = json.loads(KAT.read_text())
    assert stored.keys() == answers.keys()
    for k in ("seeds", "evaluate_z"):
        assert stored[k] == answers[k], k
    for name, tree in answers["trees"].items():
        assert stored["trees"][name]["key"] == tree["key"], name
        assert stored["trees"][name]["sums"] == tree["sums"], name


def test_answer_file_holds_the_port(answers):
    """Phase 15's checks of the streams, here: keys, bits and uniforms bit for
    bit, normals and evaluate's latents within 4 ulp (the full-width trees
    are checked on the card's host)."""
    from kpvid_tpu_torch import evaluate

    for entry in answers["seeds"]:
        key = jr.PRNGKey(entry["seed"])
        assert key.tolist() == entry["key"]
        for draw in entry["draws"]:
            shape = tuple(draw["shape"])
            assert chip_smoke.digest(jr.bits(key, shape)) == draw["bits"]
            assert chip_smoke.digest(jr.uniform(key, shape)) == draw["uniform"]
            d = chip_smoke.ulps(jr.normal(key, shape),
                                np.array(draw["normal"], np.float32).reshape(shape))
            assert int(d.max(initial=0)) <= MAX_ULP
    z = answers["evaluate_z"]
    for b, want in enumerate(z["batches"]):
        d = chip_smoke.ulps(evaluate.batch_z(z["seed"], b, z["rows"], z["vae_dim"]),
                            np.array(want, np.float32))
        assert int(d.max()) <= MAX_ULP


def test_leaf_sum_is_fixed():
    """leaf_sum adds in a fixed order: the same values give the same sum,
    within rounding of numpy's float64 sum."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3 * chip_smoke.SUM_COLUMNS + 17).astype(np.float32)
    assert chip_smoke.leaf_sum(a) == chip_smoke.leaf_sum(a.copy())
    assert abs(chip_smoke.leaf_sum(a) - float(np.sum(a, dtype=np.float64))) < 1e-9
    assert chip_smoke.leaf_sum(np.ones((5, 7), np.float32)) == 35.0


if __name__ == "__main__":  # rewrite the answer file
    KAT.parent.mkdir(parents=True, exist_ok=True)
    KAT.write_text(json.dumps(jax_answers(), separators=(",", ":")) + "\n")
    print(f"wrote {KAT}")
