"""The encoders' inference bias + BN + ReLU op (ops/inference_bn.py) on the CPU.

``kpvid::bias_bn_relu`` replaces seven torch passes after an inference
``ConvBNReLU``'s conv with one op whose CUDA kernel gives their bits. Here,
on the CPU, where the op's implementation is its plain version:

- the plain version is the passes as the layers ran them before the op:
  ``Conv.forward``'s bias add in the compute dtype, ``BatchNorm.forward``'s
  inference form, ``torch.relu``; to the bit, f32 and bf16, on random
  weights and running statistics and on inputs that land on bf16 rounding
  ties, negative values and signed zeros;
- the op's CPU implementation is the plain version, and a meta tensor reaches
  its fake implementation; the launcher refuses anything but a CUDA tensor,
  and reads the two dense layouts an activation comes in (channels-last, and
  NHWC over NCHW memory) and refuses the others;
- ``ConvBNReLU``'s inference route gives the bits of the conv, BN and ReLU
  modules run one after the other, at every kind of layer the encoders have
  (7x7, stride 2, the decoder's upsample and skip, an input over NCHW
  memory), and calls the op once; a
  forward that autograd records, training and a sharded layer run the torch
  passes and their gradients are those of today's modules;
- ``Stage1Generator.embed`` gives the image forward's ``[-2]`` without
  running the trunk's third octave, and a whole generate gives the bits of
  the layers' module-by-module route with the full trunk.

Bits are compared through an integer view, so NaN payloads and the sign of
zero count.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from kpvid_tpu_torch import ops
from kpvid_tpu_torch.configs import load_config
from kpvid_tpu_torch.eval import FinalGenerator
from kpvid_tpu_torch.models import Stage1Generator, layers
from kpvid_tpu_torch.models.layers import Conv, ConvBNReLU
from kpvid_tpu_torch.ops import bias_bn_relu, bias_bn_relu_plain
from kpvid_tpu_torch.ops import inference_bn

DTYPES = [torch.float32, torch.bfloat16]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))


def _randomize(module: torch.nn.Module, seed: int) -> None:
    """Weights N(0, 1) / sqrt(fan-in), biases and BN shifts N(0, 0.3), BN
    scales U(-1.5, 1.5) (negative ones too), running means N(0, 0.3),
    running variances U(0.2, 2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.endswith("running_var"):
                t.uniform_(0.2, 2.0, generator=g)
            elif name.endswith("bn.weight"):
                t.uniform_(-1.5, 1.5, generator=g)
            elif t.dim() == 4:
                t.normal_(0.0, float(np.prod(t.shape[1:])) ** -0.5, generator=g)
            elif t.is_floating_point():
                t.normal_(0.0, 0.3, generator=g)


def _edge_inputs(shape, dtype, seed: int):
    """(y, conv_bias, mean, mul, beta, weight, var): random y, conv bias and
    BN, mul = weight * rsqrt(var + eps) as BatchNorm makes it, and channels
    that stress the roundings: 0, a bf16 tie in the bias add (1 + 2^-8) and
    signed zeros (y = -0, bias -0, mean 0, beta -0); 1, the mean equal to t
    (+0 after the subtraction) times a negative weight, then beta -0; 2, ties
    in the final rounding ((1 or 1 + 2^-7) + 2^-8, mean 0, mul 1)."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=g) * 3
    conv_bias = torch.randn(c, generator=g) * 0.5
    mean = torch.randn(c, generator=g) * 0.3
    weight = torch.randn(c, generator=g)
    var = torch.rand(c, generator=g) * 1.8 + 0.2
    beta = torch.randn(c, generator=g) * 0.3
    flat = y.view(-1, c)
    conv_bias[0], mean[0], beta[0] = 2.0**-8, 0.0, -0.0
    flat[:, 0] = 1.0
    flat[::2, 0] = -0.0
    conv_bias[1], mean[1], weight[1], beta[1] = 0.0, 0.75, -1.25, -0.0
    flat[::2, 1] = 0.75
    conv_bias[2], mean[2], weight[2], var[2], beta[2] = 0.0, 0.0, 1.0, 1.0 - 1e-5, 2.0**-8
    flat[:, 2] = 1.0
    flat[::2, 2] = 1.0 + 2.0**-7
    mul = weight * torch.rsqrt(var + 1e-5)
    return y.to(dtype), conv_bias.to(dtype), mean, mul, beta, weight, var


def _todays_passes(y, conv_bias, mean, weight, var, beta, relu):
    """The passes as the layers wrote them before the op: Conv.forward's bias
    add, BatchNorm.forward's inference form, torch.relu."""
    x = y + conv_bias
    xf = x.float()
    mul = weight * torch.rsqrt(var + 1e-5)
    out = ((xf - mean) * mul + beta).to(x.dtype)
    return torch.relu(out) if relu else out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
def test_plain_is_the_torch_passes(dtype, relu):
    y, cb, mean, mul, beta, weight, var = _edge_inputs((3, 5, 7, 16), dtype, seed=1)
    got = bias_bn_relu_plain(y, cb, mean, mul, beta, relu)
    assert_same_bits(got, _todays_passes(y, cb, mean, weight, var, beta, relu))
    if relu:
        assert bool((got >= 0).all()) and bool(torch.signbit(got).any())  # a -0 survives
    else:
        assert bool((got < 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_keeps_nan(dtype):
    y, cb, mean, mul, beta, _, _ = _edge_inputs((2, 3, 3, 8), dtype, seed=2)
    y.view(-1)[::5] = float("nan")
    got = bias_bn_relu_plain(y, cb, mean, mul, beta, True)
    assert bool(torch.isnan(got.view(-1)[::5]).all())
    assert_same_bits(torch.ops.kpvid.bias_bn_relu(y, cb, mean, mul, beta, True), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 6, 5, 16), (1, 1, 1, 16), (4, 3, 2, 12), (2, 3, 3, 4)])
def test_op_on_the_cpu_is_the_plain_version(dtype, shape):
    args = _edge_inputs(shape, dtype, seed=3)[:5]
    ops.reset_launch_counts()
    for relu in (True, False):
        assert_same_bits(bias_bn_relu(*args, relu), bias_bn_relu_plain(*args, relu))
    assert ops.launch_counts()["bias_bn_relu"] == 0


def test_meta_reaches_the_fake_and_the_launcher_refuses_the_cpu():
    y = torch.empty(2, 4, 4, 8, device="meta", dtype=torch.bfloat16)
    v = torch.empty(8, device="meta")
    out = bias_bn_relu(y, y.new_empty(8), v, v, v, True)
    assert out.device.type == "meta" and out.shape == y.shape and out.dtype == y.dtype
    args = _edge_inputs((2, 4, 4, 8), torch.float32, seed=4)[:5]
    with pytest.raises(ValueError, match="CUDA"):
        inference_bn.launch(*args, True)


def test_channel_run_reads_both_dense_layouts_and_refuses_others():
    y = torch.zeros(2, 5, 3, 16)
    assert inference_bn.channel_run(y) == 1
    assert inference_bn.channel_run(torch.zeros(2, 16, 5, 3).permute(0, 2, 3, 1)) == 15
    assert inference_bn.channel_run(torch.zeros(1, 1, 1, 16).permute(0, 2, 1, 3)) == 1
    for bad in (y.transpose(1, 2), y[:, ::2], y[..., :8]):
        with pytest.raises(ValueError, match="dense"):
            inference_bn.channel_run(bad)


def _layer(kind: str, dtype, seed: int) -> tuple[ConvBNReLU, dict]:
    if kind == "7x7":
        layer, x, kw = ConvBNReLU(3, 16, 7, 1, dtype), (2, 12, 12, 3), {}
    elif kind == "stride2":
        layer, x, kw = ConvBNReLU(8, 16, 3, 2, dtype), (2, 9, 8, 8), {}
    elif kind == "3x3":
        layer, x, kw = ConvBNReLU(16, 16, 3, 1, dtype), (3, 8, 8, 16), {}
    else:  # the pose decoder's octave head: upsample, then the skip input
        layer, x, kw = ConvBNReLU(16 + 8, 8, 3, 1, dtype), (2, 4, 4, 16), {"up2": True}
        g = torch.Generator().manual_seed(seed + 100)
        kw["skip"] = torch.randn(2, 8, 8, 8, generator=g).to(dtype)
    _randomize(layer, seed)
    g = torch.Generator().manual_seed(seed + 200)
    return layer, {"x": torch.randn(x, generator=g).to(dtype), **kw}


def _modules_route(layer: ConvBNReLU, x, up2=False, skip=None, train=False):
    """The layer's forward as it was: the conv with its bias, BN, ReLU."""
    if up2:
        x = ops.upsample2x(x)
    if skip is not None:
        x = torch.cat([x.to(layer.conv.dtype), skip.to(layer.conv.dtype)], dim=-1)
    return torch.relu(layer.bn(layer.conv(x), train))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["7x7", "stride2", "3x3", "up2_skip"])
def test_inference_route_is_the_modules_bit_for_bit(dtype, kind):
    layer, kw = _layer(kind, dtype, seed=5)
    calls = []

    def spy(*args):
        calls.append(args)
        return bias_bn_relu(*args)

    with torch.no_grad():
        want = _modules_route(layer, **kw)
        with mock.patch.object(layers, "bias_bn_relu", spy):
            got = layer(**kw)
    assert_same_bits(got, want)
    assert len(calls) == 1 and calls[0][-1] is True


@pytest.mark.parametrize("dtype", DTYPES)
def test_inference_route_on_a_channels_first_input(dtype):
    """An input that is an NHWC view of NCHW memory (the layout cuDNN then
    keeps for the conv's output): the modules' bits."""
    layer, kw = _layer("7x7", dtype, seed=13)
    x = kw["x"].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with torch.no_grad():
        assert_same_bits(layer(x), _modules_route(layer, x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_recorded_forward_keeps_the_passes_and_their_gradients(dtype):
    layer, kw = _layer("stride2", dtype, seed=6)
    x = kw["x"].float().requires_grad_()
    with mock.patch.object(layers, "bias_bn_relu", side_effect=AssertionError("op called")):
        got = layer(x)
    want = _modules_route(layer, x)
    assert_same_bits(got, want)
    ct = torch.randn(got.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
    params = [x, layer.conv.weight, layer.conv.bias, layer.bn.weight, layer.bn.bias]
    for a, b in zip(torch.autograd.grad(got, params, ct), torch.autograd.grad(want, params, ct)):
        assert_same_bits(a, b)


@pytest.mark.parametrize("needs_grad", ["nothing", "params", "input"])
def test_grad_mode_takes_the_op_unless_autograd_would_record(needs_grad):
    """With grad mode on, the op runs only where no input or parameter needs
    a gradient; otherwise the modules run, and the output carries their graph."""
    layer, kw = _layer("3x3", torch.float32, seed=9)
    for p in layer.parameters():
        p.requires_grad_(needs_grad == "params")
    x = kw["x"].requires_grad_(needs_grad == "input")
    calls = []

    def spy(*args):
        calls.append(args)
        return bias_bn_relu(*args)

    with mock.patch.object(layers, "bias_bn_relu", spy):
        got = layer(x)
    assert_same_bits(got, _modules_route(layer, x))
    assert len(calls) == (needs_grad == "nothing")
    assert got.requires_grad == (needs_grad != "nothing")


def test_training_and_a_sharded_layer_keep_the_modules():
    layer, kw = _layer("3x3", torch.float32, seed=8)
    with mock.patch.object(layers, "bias_bn_relu", side_effect=AssertionError("op called")):
        with torch.no_grad():
            assert_same_bits(layer(**kw, train=True), _modules_route(layer, **kw, train=True))
            layer.conv.shard = object()  # a layer of a 'model' mesh, here with no slice
            assert_same_bits(layer(**kw), _modules_route(layer, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_without_its_bias(dtype):
    conv = Conv(8, 16, 3, 2, dtype=dtype)
    _randomize(conv, 9)
    x = torch.randn(2, 9, 9, 8, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        assert_same_bits(conv(x, bias=False) + conv.bias.to(dtype), conv(x))


def _smoke_stage1(dtype) -> Stage1Generator:
    m = load_config("kpvid_tpu_torch/configs/smoke.yaml").model
    s1 = Stage1Generator(m.n_pts, m.image_size, m.encoder_filters, m.translator_filters,
                         m.pose_decoder_filters, dtype).eval()
    _randomize(s1, 10)
    return s1


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_stops_after_the_second_octave(dtype):
    s1 = _smoke_stage1(dtype)
    im = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(11)) * 2 - 1
    ran = []
    for name, mod in s1.image_encoder.trunk.named_children():
        mod.register_forward_hook(lambda m, a, o, name=name: ran.append(name))
    with torch.no_grad():
        got = s1.embed(im)
        assert ran == ["in0", "in1", "down0", "keep0", "down1", "keep1"]
        want = s1.image_encoder(im)[-2]
    assert ran[6:] == ["in0", "in1", "down0", "keep0", "down1", "keep1", "down2", "keep2"]
    assert_same_bits(got, want)
    assert got.shape == (3, 8, 8, 4 * s1.image_encoder.trunk.in0.conv.weight.shape[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_gives_the_module_routes_bits(dtype):
    """A whole generate at smoke widths against the layers as they were: each
    inference ConvBNReLU as its conv, BN and ReLU modules, and embed through
    the full image trunk. 28 ops a call."""
    cfg = load_config("kpvid_tpu_torch/configs/smoke.yaml")
    cfg.training.compute_dtype = dtype
    gen = FinalGenerator(cfg, device="cpu")
    params = gen.init_parameters(0)
    g = torch.Generator().manual_seed(12)
    for key, val in params.items():
        if key.endswith("running_var"):
            val.uniform_(0.5, 2.0, generator=g)
        elif key.endswith(".bn.weight"):
            val.uniform_(0.5, 1.5, generator=g)
        elif key.endswith(("running_mean", "bias")):
            val.normal_(0.0, 0.1, generator=g)
    gen.load_parameters(params)
    rng = np.random.default_rng(12)
    im = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    act = np.eye(cfg.model.n_action, dtype=np.float32)[[1, 3]]
    z = rng.standard_normal((2, cfg.model.vae_dim)).astype(np.float32)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return bias_bn_relu(*args)

    with mock.patch.object(layers, "bias_bn_relu", spy):
        got = gen.generate(im, act, z)
    assert len(calls) == 28
    with mock.patch.object(ConvBNReLU, "forward", _modules_route), \
            mock.patch.object(Stage1Generator, "embed",
                              lambda self, im: self.image_encoder(im)[-2]):
        want = gen.generate(im, act, z)
    assert set(got) == set(want)
    for key in want:
        assert_same_bits(got[key], want[key])
