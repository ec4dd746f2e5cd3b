"""The port's profiler ranges (kpvid_tpu_torch/utils/spans.py), on the CPU at
smoke widths: ``span`` does nothing without a profiler, generation gives the
same bits with one on, one ``FinalGenerator.generate`` call records
``kpvid.generate`` with its six phases nested in order, each once (all
but ``inputs`` opened by ``GenerateNet.forward``), also per replica through
``GeneratorMesh.map`` and ``InferenceEngine.dispatch``, and the serving
artifact's graph has no profiler node. ``op_span`` records an op's range,
not a user range."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kpvid_tpu_torch.configs import Config, ModelConfig, TrainingConfig
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.eval.final import GeneratorMesh
from kpvid_tpu_torch.eval.server import InferenceEngine
from kpvid_tpu_torch.utils import spans

SMOKE = dict(
    n_pts=4, n_action=5, cell_info=(16, 16), vae_dim=8, image_size=32, heatmap_size=8,
    n_future_frames=6, encoder_filters=8, translator_filters=16, pose_decoder_filters=16,
    discriminator_filters=8,
)
PHASES = ["inputs", "detect", "motion_decode", "first_conv", "translator", "blend"]
B = 4


@pytest.fixture(scope="module")
def setup():
    """(config, parameters, a CPU generator on them, host inputs)."""
    cfg = Config(model=ModelConfig(**SMOKE), training=TrainingConfig("float32")).validate()
    gen = FinalGenerator(cfg, device="cpu")
    params = gen.init_parameters(3)
    gen.load_parameters(params)
    rng = np.random.default_rng(0)
    im = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    act = np.eye(SMOKE["n_action"], dtype=np.float32)[rng.integers(0, SMOKE["n_action"], B)]
    z = rng.standard_normal((B, SMOKE["vae_dim"])).astype(np.float32)
    return cfg, params, gen, (im, act, z)


def calls(prof) -> list[list[str]]:
    """Each recorded ``kpvid.generate`` range's phases in the order they
    started, after checking that each lies inside its call and that no two
    overlap."""
    ranges = sorted(((e.start_ns(), e.end_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("kpvid.generate")), key=lambda r: (r[0], -r[1]))
    out = []
    for t0, t1, name in ranges:
        if name == "kpvid.generate":
            out.append([])
            call, last = (t0, t1), t0
            continue
        assert name.startswith("kpvid.generate.") and out, name
        assert call[0] <= t0 and t1 <= call[1] and t0 >= last, name
        last = t1
        out[-1].append(name[len("kpvid.generate."):])
    return out


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler op for {name} with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    one, two = spans.span("kpvid.a"), spans.span("kpvid.b")
    assert one is two and isinstance(one, contextlib.nullcontext)
    with one:
        pass


def test_span_under_a_profiler_records_its_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = spans.span("kpvid.test.range")
        assert not isinstance(s, contextlib.nullcontext)
        with s:
            torch.ones(2).add_(1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("kpvid.test.range") == 1


def test_op_span_records_an_op_range_and_nothing_without_a_profiler():
    """``op_span`` is the shared null context without a profiler; under one
    it records its range as an op, not a user range (the kind the profiler
    links kernels to)."""
    assert spans.op_span("kpvid.a") is spans.span("kpvid.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.op_span("kpvid.test.op"):
            torch.ones(2).add_(1)
        with spans.span("kpvid.test.user"):
            pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert not events["kpvid.test.op"].is_user_annotation()
    assert events["kpvid.test.user"].is_user_annotation()


def test_generate_net_gives_the_same_bits_with_the_profiler_on(setup):
    _, _, gen, host = setup
    args = [torch.from_numpy(a) for a in host]
    with torch.no_grad():
        off = gen.model(*args)
        with profile(activities=[ProfilerActivity.CPU]):
            on = gen.model(*args)
    assert sorted(on) == sorted(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("latents", ["z", "key"])
def test_one_generate_call_records_its_phases_in_order(setup, latents):
    _, _, gen, (im, act, z) = setup
    kw = {"z": z} if latents == "z" else {"key": 7}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = gen.generate(im, act, **kw)
    assert calls(prof) == [PHASES]
    assert out["pred_im_seq"].shape == (B, SMOKE["n_future_frames"], 32, 32, 3)


def test_mesh_map_records_each_replicas_call(setup):
    cfg, params, _, host = setup
    mesh = GeneratorMesh(cfg, params, ["cpu", "cpu"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mesh.map(lambda rep, *rows: rep.final.generate(*rows), *host)
    assert calls(prof) == [PHASES, PHASES]


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_engine_dispatch_records_each_replicas_call(setup, devices):
    cfg, params, _, (im, _, z) = setup
    engine = InferenceEngine(cfg, params, device="cpu", devices=devices)
    actions = np.arange(B) % SMOKE["n_action"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = engine.fetch(engine.dispatch(im, actions, z))
    assert calls(prof) == [PHASES] * engine.n_data
    assert out["pred_im_seq"].shape[0] == B


@pytest.mark.parametrize("profiling", [False, True])
def test_exported_generate_net_has_no_profiler_node(setup, profiling):
    _, _, gen, host = setup
    args = tuple(torch.from_numpy(a) for a in host)
    ctx = profile(activities=[ProfilerActivity.CPU]) if profiling else contextlib.nullcontext()
    with ctx:
        program = torch.export.export(gen.model, args)
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t], targets
    assert any("kpvid" in t for t in targets)  # the kernels' ops are there
