"""The motion decode's LSTM step op (ops/lstm.py) on the CPU.

``kpvid::lstm_cell`` runs one step of one ``StackedLSTM`` layer: the gate
product and the cell update, whose CUDA kernel sums the bf16 products on the
tensor cores. Here, on the CPU, where the op's implementation is its plain
version:

- the plain version is today's ``StackedLSTM`` step to the bit (the cat of
  the rounded input and h, the f32 product of the widened operands, the f32
  bias, the gates and the cell), bf16 and f32, over a whole sequence of two
  layers; ``StackedLSTM`` still gives those bits;
- the op's CPU implementation is the plain version, a meta tensor reaches
  its fake implementation, and the launcher refuses anything but a CUDA
  tensor;
- the route: a bf16 forward that autograd does not record, with no layer
  sharded, takes the op once a step and layer, and on the CPU gives today's
  bits through it; grad recording, f32 and a sharded kernel keep the torch
  route, and a recorded forward's gradients are today's.

Bits are compared through an integer view.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import pytest
import torch

from kpvid_tpu_torch import ops
from kpvid_tpu_torch.models import StackedLSTM, layers
from kpvid_tpu_torch.ops import lstm, lstm_cell, lstm_cell_plain

DTYPES = [torch.float32, torch.bfloat16]
B, T, D, FEATURES = 5, 6, 24, (32, 40)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))


def _lstm(dtype, seed: int = 0) -> tuple[StackedLSTM, torch.Tensor]:
    """A 2-layer StackedLSTM with random kernels and biases, and xs [B, T, D]
    in ``dtype`` (the motion decoder's input is its dec_in output, in the
    compute dtype)."""
    mod = StackedLSTM(D, FEATURES, dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (p.shape[0] ** -0.5 if "kernel" in name
                                                         else 0.3))
    return mod, torch.randn(B, T, D, generator=g).to(dtype)


def _todays_forward(mod: StackedLSTM, xs: torch.Tensor) -> torch.Tensor:
    """StackedLSTM.forward as it was before the op, unsharded."""
    b, t = xs.shape[:2]
    kernels = [getattr(mod, f"lstm_{i}_kernel").to(mod.dtype).float()
               for i in range(len(mod.features))]
    biases = [getattr(mod, f"lstm_{i}_bias") for i in range(len(mod.features))]
    state = [(xs.new_zeros((b, h), dtype=torch.float32), xs.new_zeros((b, h), dtype=torch.float32))
             for h in mod.features]
    outs = []
    for step in range(t):
        inp = xs[:, step]
        for li, (c, h) in enumerate(state):
            z = torch.cat([inp.to(mod.dtype), h.to(mod.dtype)], dim=-1)
            gates = torch.matmul(z.float(), kernels[li]) + biases[li]
            i, j, f, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
            h = torch.sigmoid(o) * torch.tanh(c)
            state[li] = (c, h)
            inp = h
        outs.append(inp)
    return torch.stack(outs, dim=1)


def _plain_forward(mod: StackedLSTM, xs: torch.Tensor) -> torch.Tensor:
    """The sequence as a loop of lstm_cell_plain steps."""
    b, t = xs.shape[:2]
    kernels = [getattr(mod, f"lstm_{i}_kernel").to(mod.dtype) for i in range(len(mod.features))]
    state = [(torch.zeros(b, h), torch.zeros(b, h, dtype=mod.dtype)) for h in mod.features]
    outs = []
    for step in range(t):
        inp = xs[:, step].to(mod.dtype)
        for li, (c, h) in enumerate(state):
            h32, c, inp = lstm_cell_plain(inp, h, c, kernels[li], getattr(mod, f"lstm_{li}_bias"))
            state[li] = (c, inp)
        outs.append(h32)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_is_todays_step(dtype):
    mod, xs = _lstm(dtype, seed=1)
    with torch.no_grad():
        want = _todays_forward(mod, xs)
        assert_same_bits(_plain_forward(mod, xs), want)
        assert_same_bits(mod(xs), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_on_the_cpu_is_the_plain_version(dtype):
    g = torch.Generator().manual_seed(2)
    x, h = torch.randn(3, 16, generator=g).to(dtype), torch.randn(3, 8, generator=g).to(dtype)
    c = torch.randn(3, 8, generator=g)
    kernel, bias = torch.randn(24, 32, generator=g).to(dtype), torch.randn(32, generator=g)
    ops.reset_launch_counts()
    got, want = lstm_cell(x, h, c, kernel, bias), lstm_cell_plain(x, h, c, kernel, bias)
    for a, b in zip(got, want):
        assert_same_bits(a, b)
    assert [t.dtype for t in got] == [torch.float32, torch.float32, dtype]
    assert ops.launch_counts()["lstm_cell"] == 0


def test_meta_reaches_the_fake_and_the_launcher_refuses_the_cpu():
    bf16 = torch.bfloat16
    args = (torch.empty(4, 16, dtype=bf16), torch.empty(4, 8, dtype=bf16), torch.empty(4, 8),
            torch.empty(24, 32, dtype=bf16), torch.empty(32))
    out = lstm_cell(*(a.to("meta") for a in args))
    assert all(t.device.type == "meta" and t.shape == (4, 8) for t in out)
    assert [t.dtype for t in out] == [torch.float32, torch.float32, bf16]
    with pytest.raises(ValueError, match="CUDA"):
        lstm.launch(*args)


def _spy():
    calls = []

    def spy(*args):
        calls.append(tuple(a.shape for a in args))
        return lstm_cell(*args)

    return calls, spy


GRAD_MODES = {"off": torch.no_grad, "inference_mode": torch.inference_mode,
              "nothing_needs_it": contextlib.nullcontext}


@pytest.mark.parametrize("grad", list(GRAD_MODES))
def test_an_unrecorded_bf16_forward_takes_the_op(grad):
    """Every step and layer is one op call, and on the CPU the op gives the
    torch route's bits."""
    mod, xs = _lstm(torch.bfloat16, seed=3)
    with torch.no_grad():
        want = _todays_forward(mod, xs)
    if grad == "nothing_needs_it":
        mod.requires_grad_(False)
    calls, spy = _spy()
    ops.reset_launch_counts()
    with mock.patch.object(layers, "lstm_cell", spy), GRAD_MODES[grad]():
        got = mod(xs)
    assert_same_bits(got, want)
    assert len(calls) == len(FEATURES) * T
    assert calls[0] == ((B, D), (B, 32), (B, 32), (D + 32, 128), (128,))
    assert calls[1] == ((B, 32), (B, 40), (B, 40), (72, 160), (160,))
    assert ops.launch_counts()["lstm_cell"] == 0


@pytest.mark.parametrize("case", ["grad", "input_grad", "float32", "sharded"])
def test_the_other_forwards_keep_the_torch_route(case):
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    mod, xs = _lstm(dtype, seed=4)
    with torch.no_grad():
        want = _todays_forward(mod, xs)
    if case == "input_grad":
        mod.requires_grad_(False)
        xs = xs.float().requires_grad_()
        with torch.no_grad():
            want = _todays_forward(mod, xs)
    patches = [mock.patch.object(layers, "lstm_cell", side_effect=AssertionError("op called"))]
    if case == "sharded":  # a 'model' mesh's slice, here the whole kernel
        mod.sharded = {"lstm_0_kernel": 1}
        patches += [mock.patch.object(layers, "copy_to_model", lambda z, shard: z),
                    mock.patch.object(layers, "join", lambda t, dim, shard: t)]
    with contextlib.ExitStack() as stack, torch.set_grad_enabled(case in ("grad", "input_grad")):
        for p in patches:
            stack.enter_context(p)
        got = mod(xs)
    assert_same_bits(got, want)
    assert got.requires_grad == (case in ("grad", "input_grad"))


def test_a_recorded_forward_keeps_todays_gradients():
    mod, xs = _lstm(torch.bfloat16, seed=5)
    with mock.patch.object(layers, "lstm_cell", side_effect=AssertionError("op called")):
        got = mod(xs)
    want = _todays_forward(mod, xs)
    assert_same_bits(got, want)
    ct = torch.randn(got.shape, generator=torch.Generator().manual_seed(6))
    params = list(mod.parameters())
    for a, b in zip(torch.autograd.grad(got, params, ct), torch.autograd.grad(want, params, ct)):
        assert_same_bits(a, b)
