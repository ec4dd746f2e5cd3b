"""Fused 3x3 SAME conv + affine + ReLU: the translator decode's kernels.

Three ops of the kernels in ``csrc/conv3x3.cu`` (CUDA C++ for sm_90a):

- :func:`conv3x3_affine` replaces kpvid_tpu/ops/pallas_conv.py::conv3x3_affine
  (the ``pl.pallas_call`` at pallas_conv.py:158);
- :func:`up2_conv3_affine` replaces pallas_conv.py::up2_conv3_affine
  (pallas_conv.py:434): the same conv on the TF1-legacy 2x upsample of its
  input, which never reaches device memory. In bfloat16 it is, as on the TPU,
  #1's main loop over the low-resolution input at four times the output
  channels, one per output phase, with phase weights made on the card in the
  same call;
- :func:`conv3x3_add_affine` (#1+) replaces no TPU kernel: it is #1 with an
  f32 addend per sample read in the epilogue, the translator's split first
  conv and oct0a's BN + ReLU in one launch (eval/final.py), which JAX leaves
  to XLA (kpvid_tpu/eval/final.py::_split_first_conv,
  kpvid_tpu/ops/pallas_chain.py:90).

All three compute ``act(conv3x3_SAME(x, k) * scale + shift)`` (#1+ adds
the addend before the affine) with f32 accumulation, NHWC in and out in
``x.dtype`` (float32 or bfloat16), an HWIO kernel and f32 ``scale``/``shift``
from :func:`fold_bn`. What bounds them on an H100: the operations (2 * 9 * C
* Cout per output pixel, hundreds of flops per byte moved; #1+ at C = 40
about as many as its bytes). bfloat16, the serving path, runs them on the tensor
cores (an implicit GEMM with ``wgmma``, ``csrc/conv3x3_mma.cuh``); float32
runs on the CUDA cores, since TF32 tensor cores would not hold the f32 parity
checks.

Each wrapper calls its ``torch.ops.kpvid`` op (ops/library.py), whose CPU
implementation is the plain PyTorch version here and whose CUDA
implementation, :func:`launch`, launches the kernel or raises.
``launches`` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .resize import conv3x3_same, upsample2x

_SOURCE = "conv3x3.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(bias, gamma, beta, mean, var, eps: float = 1e-5):
    """(scale, shift) in f32 with bn(conv(x) + bias) = conv(x) * scale + shift:
    scale = gamma * rsqrt(var + eps), shift = beta + (bias - mean) * scale."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    b = 0.0 if bias is None else bias.float()
    shift = beta.float() + (b - mean.float()) * scale
    return scale, shift


def _affine(y: torch.Tensor, scale, shift, relu: bool, dtype) -> torch.Tensor:
    y = y.float() * scale + shift
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def conv3x3_affine_plain(x, kernel, scale, shift, relu: bool = True) -> torch.Tensor:
    """Plain version of :func:`conv3x3_affine`: the conv in x.dtype, then the
    affine in f32."""
    return _affine(conv3x3_same(x, kernel), scale, shift, relu, x.dtype)


def up2_conv3_affine_plain(x, kernel, scale, shift, relu: bool = True) -> torch.Tensor:
    """Plain version of :func:`up2_conv3_affine`: materialized upsample, then
    :func:`conv3x3_affine_plain`."""
    return conv3x3_affine_plain(upsample2x(x), kernel, scale, shift, relu)


def addend_frames(x_shape, addend_shape, cout: int) -> int:
    """T, the images of ``x`` per row of the addend: N / addend.shape[0].
    Raises unless the addend is [N / T, H, W, Cout] for a whole T."""
    n, h, w, _ = x_shape
    if len(addend_shape) != 4 or tuple(addend_shape[1:]) != (h, w, cout):
        raise ValueError(f"need an addend [N/T, {h}, {w}, {cout}], got {tuple(addend_shape)}")
    m = addend_shape[0]
    if m == 0 or n % m:
        raise ValueError(f"an addend of {m} rows does not divide {n} images")
    return n // m


def conv3x3_add_affine_plain(x, kernel, addend, scale, shift, relu: bool = True) -> torch.Tensor:
    """Plain version of :func:`conv3x3_add_affine`: the conv in x.dtype, then
    each image's addend row, the affine and the ReLU in f32."""
    y = conv3x3_same(x, kernel).float()
    t = addend_frames(x.shape, addend.shape, kernel.shape[3])
    y = (y.unflatten(0, (-1, t)) + addend.float()[:, None]).flatten(0, 1)
    return _affine(y, scale, shift, relu, x.dtype)


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_kpvid_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kpvid_conv3x3_affine.argtypes = [i, i, p, p, p, p, i, p, p, p, i, i, i, i, i, i, p]
        lib.kpvid_conv3x3_affine.restype = i
        lib.kpvid_cuda_error_string.argtypes = [i]
        lib.kpvid_cuda_error_string.restype = ctypes.c_char_p
        lib._kpvid_bound = True
    return lib


def launch(x, kernel, scale, shift, relu: bool, up2: bool, addend=None) -> torch.Tensor:
    """Launch #1 (or #2 with ``up2``, #1+ with an ``addend``) on CUDA tensors;
    the ops' CUDA implementation."""
    if x.device.type != "cuda":
        raise ValueError(f"the conv3x3 kernel runs on a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"need a contiguous NHWC tensor, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, c) or kernel.dim() != 4:
        raise ValueError(f"need a [3,3,{c},Cout] kernel, got {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    kernel = kernel.to(x.dtype).contiguous()
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    for t in (kernel, scale, shift):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale/shift must be [{cout}]")
    frames = 0
    if addend is not None:
        if up2:
            raise ValueError("the addend has no upsampled form")
        frames = addend_frames(x.shape, addend.shape, cout)
        addend = addend.float().contiguous()
        if addend.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {addend.device}")
    oh, ow = (2 * h, 2 * w) if up2 else (h, w)
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    work = None
    if up2 and x.dtype == torch.bfloat16:
        # the phase weights [3, 3, C, 4 Fp] (Fp: Cout rounded up to 64), which
        # the call writes before its conv reads them
        fp = -(-cout // 64) * 64
        work = torch.empty(9 * c * 4 * fp, dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.kpvid_conv3x3_affine(
        _DTYPES[x.dtype], int(up2), x.data_ptr(), kernel.data_ptr(),
        None if work is None else work.data_ptr(),
        None if addend is None else addend.data_ptr(), frames, scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), n, h, w, c, cout, int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"conv3x3 kernel launch failed: {lib.kpvid_cuda_error_string(err).decode()}"
        )
    if addend is not None:
        conv3x3_add_affine.launches += 1
    else:
        (up2_conv3_affine if up2 else conv3x3_affine).launches += 1
    return out


def conv3x3_affine(x, kernel, scale, shift, relu: bool = True) -> torch.Tensor:
    """act(conv3x3_SAME(x, kernel) * scale + shift).

    x: [N, H, W, C] float32 or bfloat16; kernel: [3, 3, C, Cout] HWIO;
    scale/shift: [Cout] f32 -> [N, H, W, Cout] in x.dtype."""
    return torch.ops.kpvid.conv3x3_affine(x, kernel, scale, shift, relu)


def up2_conv3_affine(x, kernel, scale, shift, relu: bool = True) -> torch.Tensor:
    """act(conv3x3_SAME(upsample2x_tf1(x), kernel) * scale + shift).

    x: [N, H, W, C]; kernel: [3, 3, C, F] -> [N, 2H, 2W, F] in x.dtype."""
    return torch.ops.kpvid.up2_conv3_affine(x, kernel, scale, shift, relu)


def conv3x3_add_affine(x, kernel, addend, scale, shift, relu: bool = True) -> torch.Tensor:
    """act((conv3x3_SAME(x, kernel) + addend[n // T]) * scale + shift), T =
    N / addend.shape[0], the sum and the affine in f32.

    x: [N, H, W, C]; kernel: [3, 3, C, Cout]; addend: [N / T, H, W, Cout] f32;
    scale/shift: [Cout] f32 -> [N, H, W, Cout] in x.dtype."""
    return torch.ops.kpvid.conv3x3_add_affine(x, kernel, addend, scale, shift, relu)


conv3x3_affine.launches = 0
up2_conv3_affine.launches = 0
conv3x3_add_affine.launches = 0
