"""The port's ``train_step_multi`` (both stages) against kpvid_tpu's, on the CPU.

JAX's ``train_step_multi`` is a ``lax.scan`` of K 'fused' ``train_step``s
over [K, B, ...] stacked batches (and, in stage 2, K stacked keys). The
port's is, on the CPU, the loop of K eager ``train_step``s; on the card one
step captured as a CUDA graph and replayed K times (tests/test_torch_gpu.py
holds that against the eager steps). Smoke widths, f32, K = 3, the setups of
tests/test_torch_train.py (stage 2) and tests/test_torch_stage1.py (stage 1,
BN statistics, BN affine and biases randomized, and that file's batches).

Tolerances: stage 2's metrics rtol 1e-5 and parameters those of
``test_torch_train.py::test_train_steps_match_jax`` (atol 2e-6, 2 lr per
step on sign steps); stage 1's against JAX's multi those JAX's own test
holds its multi to (3 lr a step on the parameters; the BN statistics 1e-5,
metrics rtol 1e-4), and against JAX's sequential steps
``test_torch_stage1.py``'s 3-step tolerances with its documented
exceptions (test_stage1_multi_matches_jax says why both). The port's multi against K of
its own ``train_step``s, a resume from a checkpoint written after it, and
the rates it applies are exact.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_stage1 as s1t
import test_torch_train as s2t
from kpvid_tpu.train.stage2 import Stage2Trainer as JaxStage2Trainer
from kpvid_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

K = 3
S2_METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_init2():
    return jax.device_get(JaxStage2Trainer(s2t.jax_config()).init_state(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_init1():
    state = s1t.jax_trainer().init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    state = state.replace(g_params=s1t.randomize(state.g_params, rng),
                          batch_stats=s1t.randomize(state.batch_stats, rng),
                          d_params=s1t.randomize(state.d_params, rng))
    return jax.device_get(state)


def stack(batches: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def stage2_inputs(seed: int):
    """K batches stacked, K JAX keys and the K noise draws JAX's step makes
    from them (``_make_noise``)."""
    jt = JaxStage2Trainer(s2t.jax_config())
    batches = stack([s2t.make_batch(seed + i) for i in range(K)])
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    noises = np.stack([np.asarray(jt._make_noise(key, s2t.B)) for key in keys])
    return batches, keys, noises


@pytest.mark.parametrize("start", [0, 7])
def test_stage2_multi_matches_jax(jax_init2, start):
    """The port's multi (the K eager steps on the CPU) against JAX's
    jitted ``train_step_multi`` on the same stacked batches and JAX's noise,
    from step 0 and from step 7 with a fresh optimizer (the state an import
    at ``--step 7`` writes): every metric of every step within rtol 1e-5,
    ``lr`` included (JAX logs the schedule at the step), the parameters
    within test_torch_train.py's bounds; the updates take the schedule at
    the optimizer's count (lr(0), lr(1), lr(2)), not at the step."""
    batches, keys, noises = stage2_inputs(40)
    jt = JaxStage2Trainer(s2t.jax_config())
    state = jax_init2.replace(step=jnp.asarray(start, jnp.int32))
    want_state, want = jt.jitted_train_step_multi(jax.tree.map(jnp.copy, state), batches, keys)
    want_state = jax.device_get(want_state)

    trainer = s2t.port_trainer(jax_init2)
    trainer.step = start
    first_grads, rates = s2t.record_updates(trainer)
    got = trainer.train_step_multi(batches, noises)
    assert trainer.step == start + K == int(want_state.step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (K,), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=S2_METRIC_RTOL,
                                   err_msg=k)
    assert rates == [trainer.lr_schedule(i) for i in range(K) for _ in range(2)]
    np.testing.assert_array_equal(got["lr"].numpy(), np.float32(
        [trainer.lr_schedule(start + i + 1) for i in range(K)]))
    grads = {name: first_grads[id(p)] for name, p in trainer.model.named_parameters()}
    s2t.assert_params_match_jax(trainer, want_state, grads, K, jax_init2)


def test_stage1_multi_matches_jax(jax_init1):
    """Stage 1's multi against JAX's jitted ``train_step_multi`` on
    test_torch_stage1.py's batches: metrics of every step within rtol 1e-4,
    the BN statistics within 1e-5, the parameters within the envelope JAX's
    own test holds its multi to against its sequential steps, 3 lr a step
    (tests/test_train.py): the scan compiles other fusions than the step,
    and one BN scale of JAX's multi is 2.3e-6 from JAX's sequential steps
    (past test_torch_stage1.py's 2e-6). Against JAX's 3 sequential steps
    the port's multi holds test_torch_stage1.py's 3-step tolerances."""
    batches = [s1t.make_batch(10 + i) for i in range(6)]  # test_torch_stage1.py's
    jt = s1t.jax_trainer()
    want_state, want = jt.jitted_train_step_multi(jax.tree.map(jnp.copy, jax_init1),
                                                  stack(batches[:K]))
    want_state = jax.device_get(want_state)
    seq_state, _ = s1t._run_jax("fused", jax_init1, batches, K)

    trainer = s1t.port_trainer(jax_init1)
    first_grads, rates = s2t.record_updates(trainer)
    got = trainer.train_step_multi(stack(batches[:K]))
    assert trainer.step == K == int(want_state.step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (K,), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=s1t.METRIC_RTOL,
                                   err_msg=k)
    assert rates == [trainer.lr_schedule(i) for i in range(K) for _ in range(2)]
    envelope = 3 * s1t.LR * K
    want_arrays = s1t.port_params(want_state)
    for name, val in trainer.model.state_dict().items():
        bound = s1t.STATS_ATOL if "running_" in name else envelope
        assert float((val - want_arrays[name]).abs().max()) <= bound, name
    grads = {name: first_grads[id(p)] for name, p in trainer.model.named_parameters()}
    s1t.assert_state_matches_jax(trainer, seq_state, grads, K, jax_init1)


def _stage(stage: int, jax_init1, jax_init2):
    """(a fresh trainer from the JAX init, K stacked inputs, run multi, run one step)."""
    if stage == 1:
        batches = [s1t.make_batch(60 + i) for i in range(K + 1)]
        return (lambda: s1t.port_trainer(jax_init1), stack(batches[:K]),
                lambda t: t.train_step_multi(stack(batches[:K])),
                lambda t, i: t.train_step(batches[i]))
    stacked, _, noises = stage2_inputs(60)
    extra = s2t.make_batch(60 + K)
    noise = np.random.default_rng(3).standard_normal((s2t.B, 8)).astype(np.float32)
    return (lambda: s2t.port_trainer(jax_init2), stacked,
            lambda t: t.train_step_multi(stacked, noises),
            lambda t, i: (t.train_step({k: v[i] for k, v in stacked.items()}, noises[i])
                          if i < K else t.train_step(extra, noise)))


def _same_arrays(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(torch.as_tensor(a[k]),
                                                      torch.as_tensor(b[k])) for k in a)


@pytest.mark.parametrize("stage", [1, 2])
def test_multi_is_k_train_steps(jax_init1, jax_init2, stage):
    """On the CPU the multi is K of the port's own ``train_step``s to the
    bit, metrics and every array of the state; the step advances by K; from
    an imported state (step 7, a fresh optimizer) the K updates take lr(0),
    lr(1), lr(2) of the optimizer's count, and a second call goes on from
    lr(3)."""
    make, _, multi, single = _stage(stage, jax_init1, jax_init2)
    for start in (0, 7):
        a, b = make(), make()
        for t in (a, b):
            t.load_state_arrays(dict(t.state_arrays(), step=torch.tensor(start)))
        _, rates = s2t.record_updates(a)
        got = multi(a)
        want = [single(b, i) for i in range(K)]
        assert a.step == b.step == start + K
        assert sorted(got) == sorted(want[0])
        assert all(torch.equal(got[k], torch.stack([torch.as_tensor(w[k], dtype=torch.float32)
                                                    for w in want])) for k in got)
        assert _same_arrays(a.state_arrays(), b.state_arrays())
        assert rates == [a.lr_schedule(i) for i in range(K) for _ in range(2)]
    multi(a)
    assert rates[2 * K:] == [a.lr_schedule(i) for i in range(K, 2 * K) for _ in range(2)]


@pytest.mark.parametrize("stage", [1, 2])
def test_checkpoint_after_multi_resumes(jax_init1, jax_init2, stage, tmp_path):
    """A checkpoint written after a multi call holds the bits of K single
    steps (Adam's step count a host f32 tensor of K, as the checkpoint code
    reads it), and a trainer resumed from it takes step K + 1 to the bits of
    the trainer that ran K + 1 single steps."""
    make, _, multi, single = _stage(stage, jax_init1, jax_init2)
    a, b = make(), make()
    multi(a)
    for i in range(K):
        single(b, i)
    step_of = next(v for k, v in a.g_opt.state.items())["step"]
    assert step_of.device.type == "cpu" and step_of.dtype == torch.float32 and int(step_of) == K
    path = save_checkpoint(tmp_path, "multi", a.step, a.state_arrays())
    assert _same_arrays(load_checkpoint(path), {k: v.numpy() for k, v in b.state_arrays().items()})
    c = make()
    c.load_state_arrays(load_checkpoint(path))
    for t in (b, c):
        single(t, K)
    assert c.step == K + 1 and _same_arrays(c.state_arrays(), b.state_arrays())


@pytest.mark.parametrize("stage", [1, 2])
def test_multi_refuses_a_mesh_and_ragged_stacks(jax_init1, jax_init2, stage):
    """JAX's multi has no data-parallel form: a trainer on a mesh refuses
    it before it steps; stacked arrays of different step counts are refused."""
    make, stacked, multi, _ = _stage(stage, jax_init1, jax_init2)
    t = make()
    t.mesh = types.SimpleNamespace()
    with pytest.raises(ValueError, match="no data-parallel form"):
        multi(t)
    t.mesh = None
    with pytest.raises(ValueError, match="different step counts"):
        t._multi(dict(stacked, extra=np.zeros((K + 1, 1), np.float32)))
    assert t.step == 0
