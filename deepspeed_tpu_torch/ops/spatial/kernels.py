"""Spatial (diffusers / UNet) ops: kernel S ``csrc/spatial_bias_add.cu``
and its plain PyTorch version (counterpart of
``deepspeed_tpu/ops/spatial/kernels.py``; reference
``csrc/spatial/csrc/opt_bias_add.cu``: ``nhwc_bias_add``,
``nhwc_bias_add_add``, ``nhwc_bias_add_bias_add``).

Replaces no ``pallas_call`` site: the JAX package writes each form as a
chain of adds, which XLA fuses into one elementwise pass. Eager PyTorch
pays one full pass over the activation for every add; S does each form in
one pass, each add in fp32 rounded to the dtype after it, the plain chain's
order, so the two agree bit for bit.

What bounds it on the H100: bytes (the activation read, ``other`` read in
the residual forms, the output written) over 3.35 TB/s; 16-byte vectors,
the biases staged in shared memory once a CTA.

Each function takes the plain version for CPU tensors only and, for CUDA
tensors, launches S on the current stream or raises. The wrappers read
nothing from the device, so a CUDA graph can capture them. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build

__all__ = ["nhwc_bias_add", "nhwc_bias_add_add", "nhwc_bias_add_bias_add"]

#: kernel launches since the last reset (set it to 0 to start counting)
launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
# the biases a CTA stages in shared memory: at most 48 KB (the kernel's limit)
_MAX_SMEM = 48 * 1024


def _bcast(bias, ndim):
    return bias.reshape((1,) * (ndim - 1) + (-1,))


def nhwc_bias_add_plain(activation, bias):
    """[N, H, W, C] + [C]."""
    return activation + _bcast(bias, activation.ndim)


def nhwc_bias_add_add_plain(activation, bias, other):
    """(a + bias) + other: the fused residual form."""
    return nhwc_bias_add_plain(activation, bias) + other


def nhwc_bias_add_bias_add_plain(activation, bias, other, other_bias):
    """(a + bias) + (other + other_bias): the double-bias residual form."""
    return nhwc_bias_add_plain(activation, bias) + nhwc_bias_add_plain(other, other_bias)


def _lib():
    fn = build.load("spatial_bias_add").ds_spatial_bias_add
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, a):
    if x.device != a.device:
        raise ValueError(f"{name} is on {x.device}, the activation on {a.device}")
    if x.dtype != a.dtype:
        raise TypeError(f"{name} is {x.dtype}, the activation {a.dtype}: S takes one dtype")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def spatial_bias_add_cuda(mode, activation, bias, other=None, other_bias=None):
    """Launch S on CUDA tensors: mode 0 ``a + bias``, 1 ``(a + bias) +
    other``, 2 ``(a + bias) + (other + other_bias)``. ``a`` and ``other``
    ``[..., C]``, the biases ``[C]``, all of one dtype (fp16, bf16 or fp32),
    contiguous and 16-byte aligned, C a multiple of 16 bytes."""
    global launches
    a = activation
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"nhwc bias add kernel takes fp16/bf16/fp32, got {a.dtype}")
    C = a.shape[-1]
    vec = 16 // a.element_size()
    if C % vec:
        raise ValueError(f"nhwc bias add kernel needs C a multiple of {vec} in {a.dtype}, "
                         f"got {C}")
    _check("activation", a, a)
    operands = [("bias", bias)] + ([("other", other)] if mode >= 1 else []) \
        + ([("other_bias", other_bias)] if mode == 2 else [])
    for name, x in operands:
        _check(name, x, a)
        want = (C,) if "bias" in name else tuple(a.shape)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} shape {tuple(x.shape)}, expected {want}")
    if C * a.element_size() * (2 if mode == 2 else 1) > _MAX_SMEM:
        raise ValueError(f"nhwc bias add kernel stages at most {_MAX_SMEM} bytes of bias "
                         f"a CTA; C {C} in {a.dtype} is too wide")
    out = torch.empty_like(a)
    R = a.numel() // C
    idx = a.device.index
    with torch.cuda.device(idx):
        rc = _lib()(mode, a.data_ptr(), bias.data_ptr(),
                    other.data_ptr() if other is not None else None,
                    other_bias.data_ptr() if other_bias is not None else None,
                    out.data_ptr(), R, C, _DTYPE_CODE[a.dtype],
                    torch.cuda.current_stream(idx).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nhwc bias add launch failed: CUDA error {rc}")
    launches += 1
    return out


def _dispatch(mode, plain, activation, *rest):
    if activation.is_cuda:
        return spatial_bias_add_cuda(mode, activation, *rest)
    if activation.device.type == "cpu":
        return plain(activation, *rest)
    raise ValueError(f"nhwc bias add: no kernel for device {activation.device}")


def nhwc_bias_add(activation, bias):
    """``activation [N, H, W, C] + bias [C]``: S for CUDA tensors, the plain
    version for CPU tensors."""
    return _dispatch(0, nhwc_bias_add_plain, activation, bias)


def nhwc_bias_add_add(activation, bias, other):
    """``(activation + bias) + other``: S for CUDA tensors, the plain
    version for CPU tensors."""
    return _dispatch(1, nhwc_bias_add_add_plain, activation, bias, other)


def nhwc_bias_add_bias_add(activation, bias, other, other_bias):
    """``(activation + bias) + (other + other_bias)``: S for CUDA tensors,
    the plain version for CPU tensors."""
    return _dispatch(2, nhwc_bias_add_bias_add_plain, activation, bias, other, other_bias)
