"""The encoders' inference conv bias, BN and ReLU as one pass.

:func:`bias_bn_relu` replaces no TPU kernel: the JAX package leaves a
``ConvBNReLU``'s bias add, BN and ReLU to XLA's fusion of its jnp ops
(kpvid_tpu/models/layers.py), with no ``pallas_call``. In eager PyTorch that
arithmetic after cuDNN's conv is seven passes over the activation;
``csrc/bias_bn_relu.cu`` does the same operations in the same order with the
same roundings in one pass, so the bits are those of the passes. Bound: the
activation's bytes, read once and written once (4 bytes an element in
bfloat16).

models/layers.py::ConvBNReLU takes it for every inference forward of an
unsharded layer (the image and pose encoders' trunks and the pose decoder).
The op is ``kpvid::bias_bn_relu`` (ops/library.py): its CPU implementation is
:func:`bias_bn_relu_plain`, its CUDA implementation :func:`launch`, which
launches the kernel or raises. ``bias_bn_relu.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SOURCE = "bias_bn_relu.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bias_bn_relu_plain(y, conv_bias, mean, mul, beta, relu: bool = True) -> torch.Tensor:
    """The passes the kernel replaces, as torch ops: the conv bias added in
    y.dtype (``conv_bias`` already cast to it), then in f32 ``(t - mean) *
    mul + beta``, rounded to y.dtype, then the ReLU."""
    t = y + conv_bias
    out = ((t.float() - mean) * mul + beta).to(y.dtype)
    return torch.relu(out) if relu else out


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_kpvid_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.kpvid_bias_bn_relu.argtypes = [i, p, p, p, p, p, p, ll, i, ll, i, p]
        lib.kpvid_bias_bn_relu.restype = i
        lib.kpvid_cuda_error_string.argtypes = [i]
        lib.kpvid_cuda_error_string.restype = ctypes.c_char_p
        lib._kpvid_bound = True
    return lib


def channel_run(y: torch.Tensor) -> int:
    """How many consecutive elements of ``y`` [..., C] in memory share a
    channel: 1 where y is contiguous (channels-last), H * W where a 4-D y
    is [N, H, W, C] over NCHW memory (what cuDNN returns for an input laid
    out so, which the op's output keeps). Raises on any other layout."""
    if y.dim() >= 1 and y.is_contiguous():
        return 1
    if y.dim() == 4 and y.permute(0, 3, 1, 2).is_contiguous():
        return y.shape[1] * y.shape[2]
    raise ValueError(f"need a dense channels-last or channels-first tensor, got shape "
                     f"{tuple(y.shape)} strides {y.stride()}")


def launch(y, conv_bias, mean, mul, beta, relu: bool) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; the op's CUDA implementation. y is
    a [..., C] tensor in float32 or bfloat16 laid out as :func:`channel_run`
    takes, ``conv_bias`` [C] in y.dtype, ``mean``, ``mul`` and ``beta`` [C]
    float32; the output has y's layout."""
    if y.device.type != "cuda":
        raise ValueError(f"the bias_bn_relu kernel runs on a CUDA tensor, got {y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"bias_bn_relu kernel takes float32 or bfloat16, got {y.dtype}")
    inner = channel_run(y)
    c = y.shape[-1]
    if conv_bias.dtype != y.dtype:
        raise TypeError(f"conv_bias must be {y.dtype}, got {conv_bias.dtype}")
    for name, t in (("mean", mean), ("mul", mul), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("conv_bias", conv_bias), ("mean", mean), ("mul", mul), ("beta", beta)):
        if tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{c}], got {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"all operands must be on {y.device}, got {t.device}")
    out = torch.empty_like(y)
    lib = _lib()
    err = lib.kpvid_bias_bn_relu(
        _DTYPES[y.dtype], y.data_ptr(), conv_bias.data_ptr(), mean.data_ptr(), mul.data_ptr(),
        beta.data_ptr(), out.data_ptr(), y.numel(), c, inner, int(relu),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"bias_bn_relu kernel launch failed: {lib.kpvid_cuda_error_string(err).decode()}"
        )
    bias_bn_relu.launches += 1
    return out


def bias_bn_relu(y, conv_bias, mean, mul, beta, relu: bool = True) -> torch.Tensor:
    """relu(round((float(y + conv_bias) - mean) * mul + beta)) per channel of
    the last axis, in y.dtype: a conv's bias add and an inference BN (``mul``
    = weight * rsqrt(var + eps)) with its ReLU, as one op."""
    return torch.ops.kpvid.bias_bn_relu(y, conv_bias, mean, mul, beta, relu)


bias_bn_relu.launches = 0
