"""One step of one LSTM layer: the gate product and the cell update as one op.

:func:`lstm_cell` replaces no TPU kernel: the JAX package's StackedLSTM
(kpvid_tpu/models/layers.py) leaves its preferred_element_type=f32 dot and
the gates to XLA's fusion, with no ``pallas_call``. In eager PyTorch a step
and layer is a cat, casts, an f32 product of the bf16-rounded operands, a
bias add and ~10 passes over the gates; ``csrc/lstm_cell.cu`` does the
product on the tensor cores (bf16 x bf16, exact in f32, summed in f32) with
the cell update in its epilogue, so only the order of the f32 sums differs.
Bound: the kernel's bytes, [D+H, 4H] in bfloat16, read once a call.

models/layers.py::StackedLSTM takes it for every step and layer of a bf16
forward that autograd does not record, with no layer sharded (generate's
motion decode: 2 layers x 32 steps), on the CPU too. The op is
``kpvid::lstm_cell`` (ops/library.py): its CPU implementation is
:func:`lstm_cell_plain`, its CUDA implementation :func:`launch`, which
launches the kernel or raises. ``lstm_cell.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SOURCE = "lstm_cell.cu"


def cell_update(gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, c) after an LSTM step from its f32 gates [B, 4H] (i, j, f, o) and
    the f32 cell state [B, H], with the forget bias 1.0."""
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_cell_plain(x, h, c, kernel, bias) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step as torch ops: ``[x, h]`` (both in kernel.dtype) times the
    kernel [D+H, 4H], widened to f32 and multiplied in f32, plus the f32
    bias, then :func:`cell_update`. Returns (h f32, c f32, h in
    kernel.dtype)."""
    z = torch.cat([x, h], dim=-1)
    h, c = cell_update(torch.matmul(z.float(), kernel.float()) + bias, c)
    return h, c, h.to(kernel.dtype, copy=True)


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_kpvid_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kpvid_lstm_cell.argtypes = [p, ll, p, ll, p, p, p, p, p, p, i, i, i, p]
        lib.kpvid_lstm_cell.restype = i
        lib.kpvid_cuda_error_string.argtypes = [i]
        lib.kpvid_cuda_error_string.restype = ctypes.c_char_p
        lib._kpvid_bound = True
    return lib


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` [B, n] with unit stride along n (a copy where it has not)."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be [B, n], got shape {tuple(t.shape)}")
    return t if t.stride(1) == 1 and t.stride(0) >= t.shape[1] else t.contiguous()


def launch(x, h, c, kernel, bias) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; the op's CUDA implementation. x
    [B, D] and h [B, H] bfloat16 (any row stride), c [B, H] float32, kernel
    [D+H, 4H] bfloat16 and bias [4H] float32, dense."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the lstm_cell kernel runs on a CUDA tensor, got {dev}")
    for name, t, dtype in (("x", x, torch.bfloat16), ("h", h, torch.bfloat16),
                           ("c", c, torch.float32), ("kernel", kernel, torch.bfloat16),
                           ("bias", bias, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"lstm_cell kernel takes {name} in {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {name} on {t.device}")
    x, h = _rows(x, "x"), _rows(h, "h")
    (b, d), hid = x.shape, h.shape[1]
    want = {"h": (h, (b, hid)), "c": (c, (b, hid)), "kernel": (kernel, (d + hid, 4 * hid)),
            "bias": (bias, (4 * hid,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    c, kernel, bias = c.contiguous(), kernel.contiguous(), bias.contiguous()
    h_out = torch.empty((b, hid), device=dev, dtype=torch.float32)
    c_out = torch.empty_like(h_out)
    h16 = torch.empty((b, hid), device=dev, dtype=torch.bfloat16)
    lib = _lib()
    err = lib.kpvid_lstm_cell(
        x.data_ptr(), x.stride(0), h.data_ptr(), h.stride(0), c.data_ptr(), kernel.data_ptr(),
        bias.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), h16.data_ptr(), b, d, hid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"lstm_cell kernel launch failed: {lib.kpvid_cuda_error_string(err).decode()}")
    lstm_cell.launches += 1
    return h_out, c_out, h16


def lstm_cell(x, h, c, kernel, bias) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM step of one layer: ``[x, h] @ kernel + bias`` with f32
    products and sums, then the gates (i, j, f, o, forget bias 1.0) and the
    f32 cell. x [B, D] and h [B, H] in the compute dtype, c [B, H] float32,
    kernel [D+H, 4H] in the compute dtype, bias [4H] float32 -> (h float32,
    c float32, h in the compute dtype)."""
    return torch.ops.kpvid.lstm_cell(x, h, c, kernel, bias)


lstm_cell.launches = 0
