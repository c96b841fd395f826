"""Int8 weight-only dequantisation: the CUDA kernel ``csrc/dequant_int8.cu``
and its plain PyTorch version.

Replaces no ``pallas_call`` site: the JAX package's ``Quantized8.dequant``
(``deepspeed_tpu/ops/quant.py:35``) is ``(q.astype(f32) * scale).astype
(bf16)``, which XLA fuses into the operand read of the matmul that uses the
weight. Eager PyTorch would write an fp32 copy of the matrix first; the
kernel reads the int8 payload and its fp32 group scales once and writes the
16-bit matrix once, with one fp32 product and one rounding an element, as
JAX computes it (so the two agree bit for bit).

What bounds it on the H100: bytes (1 read and 2 written an element, the
scales besides) over 3.35 TB/s; 16-byte loads and stores, one vector of 16
elements a thread.

:func:`dequant_int8` takes the plain version for CPU tensors only and for
CUDA tensors launches the kernel or raises. ``launches`` counts kernel
launches (a run's proof that its matmuls read their weights through it).
"""

from __future__ import annotations

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build

#: kernel launches since the last reset (set it to 0 to start counting)
launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1}


def dequant_int8_plain(q, scale, dtype=torch.bfloat16):
    """``q`` int8 ``[..., C]`` times its fp32 group scales ``[..., groups]``
    (group g covers columns ``g * C / groups ..``) in fp32, rounded once to
    ``dtype``."""
    groups = scale.shape[-1]
    *lead, last = q.shape
    w = q.reshape(*lead, groups, last // groups).float() * scale.float()[..., None]
    return w.reshape(*lead, last).to(dtype)


def _lib():
    fn = build.load("dequant_int8").ds_dequant_int8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def dequant_int8_cuda(q, scale, dtype=torch.bfloat16):
    """Launch the kernel on CUDA tensors: ``q`` int8 and ``scale`` fp32 on
    one device, out in fp16 or bf16."""
    global launches
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dequant_int8 kernel writes fp16/bf16, got {dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequant_int8 kernel takes int8 q and fp32 scales, got "
                        f"{q.dtype} and {scale.dtype}")
    if q.device != scale.device:
        raise ValueError(f"scale is on {scale.device}, q on {q.device}")
    *lead, C = q.shape
    groups = scale.shape[-1]
    if tuple(scale.shape[:-1]) != tuple(lead) or C % groups:
        raise ValueError(f"scale shape {tuple(scale.shape)} does not group q {tuple(q.shape)} "
                         "over its last axis")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_int8 kernel takes contiguous q and scales")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    R = q.numel() // C if C else 0
    idx = q.device.index
    with torch.cuda.device(idx):
        rc = _lib()(q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C, groups,
                    _DTYPE_CODE[dtype], torch.cuda.current_stream(idx).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_int8 launch failed: CUDA error {rc}")
    launches += 1
    return out


def dequant_int8(q, scale, dtype=torch.bfloat16):
    """The matrix ``q * scale`` in ``dtype``: the kernel for CUDA tensors,
    :func:`dequant_int8_plain` for CPU tensors."""
    if q.is_cuda:
        return dequant_int8_cuda(q, scale, dtype)
    if q.device.type == "cpu":
        return dequant_int8_plain(q, scale, dtype)
    raise ValueError(f"dequant_int8: no kernel for device {q.device}")
