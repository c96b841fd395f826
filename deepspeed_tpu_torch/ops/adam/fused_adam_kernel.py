"""Fused Adam: the CUDA kernel ``csrc/fused_adam.cu`` (kernel E) and its
plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/adam/fused_adam_kernel.py``
``_adam_kernel`` (K4): one Adam/AdamW pass over one flat parameter leaf,
emitting either the new parameter (``emit="param"``) or the positive descent
direction ``u`` (``emit="update"``, which the engine applies as
``master - lr * u`` with its scheduled lr). Moments are fp32.

What bounds it on the H100: memory. It reads p, g, m, v once and writes the
output and m, v once (about 28 bytes an element with fp32 p and g); the
kernel moves them as 16-byte vectors in one grid-stride pass and keeps all
arithmetic in registers. One launch per leaf, as the JAX optimizer runs the
TPU kernel per leaf; a multi-tensor launch is later work.

Unlike the JAX function, which returns new arrays, :func:`fused_adam_step`
updates ``m`` and ``v`` in place (and ``p`` too when ``out=p``): the port
trades purity for not holding a second copy of the optimizer state. It takes
the plain version for CPU tensors only; for a CUDA tensor it launches the
kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import build

#: kernel launches since the last reset (set it to 0 to start counting)
launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
_EMITS = ("param", "update")


def bias_corrections(step, b1: float, b2: float, bias_correction: bool = True):
    """``(1 - b1^step, 1 - b2^step)`` computed in fp32, as the JAX wrapper
    does (``fused_adam_kernel.py:144-146``); ``(1, 1)`` when off."""
    if not bias_correction:
        return 1.0, 1.0
    s = torch.tensor(float(step), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    bc1 = one - torch.tensor(b1, dtype=torch.float32) ** s
    bc2 = one - torch.tensor(b2, dtype=torch.float32) ** s
    return float(bc1), float(bc2)


def fused_adam_plain(p, g, m, v, lr: float, bc1: float, bc2: float, *, b1: float, b2: float,
                     eps: float, weight_decay: float, adam_w_mode: bool, emit: str):
    """The kernel's math in plain PyTorch (``_jnp_adam_flat``), one fp32 op
    at a time. Pure: returns ``(out, new_m, new_v)``, with ``out`` the new
    param in p's dtype (emit "param") or the fp32 update direction."""
    wd = weight_decay
    g = g.float()
    pf = p.float()
    if not adam_w_mode and wd:
        g = g + wd * pf
    m = b1 * m.float() + (1.0 - b1) * g
    v = b2 * v.float() + (1.0 - b2) * (g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if adam_w_mode and wd:
        upd = upd + wd * pf
    if emit == "param":
        return (pf - lr * upd).to(p.dtype), m, v
    return upd, m, v


def _check(name, x, n, dtypes):
    if x.dim() != 1 or x.numel() != n:
        raise ValueError(f"{name} must be a flat tensor of {n} elements, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} dtype {x.dtype} not in {dtypes}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel(p, g, m, v, out, emit, lr, bc1, bc2, b1, b2, eps, wd, adam_w):
    global launches
    n = p.numel()
    _check("p", p, n, tuple(_DTYPE_CODE))
    _check("g", g, n, tuple(_DTYPE_CODE))
    _check("m", m, n, (torch.float32,))
    _check("v", v, n, (torch.float32,))
    _check("out", out, n, (p.dtype if emit == "param" else torch.float32,))
    for name, x in (("g", g), ("m", m), ("v", v), ("out", out)):
        if x.device != p.device:
            raise ValueError(f"{name} is on {x.device}, p on {p.device}")
    fn = build.load("fused_adam").ds_fused_adam
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, P, I, P, P, P, ctypes.c_long, I, I] + [F] * 9 + [P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(), _DTYPE_CODE[g.dtype],
                m.data_ptr(), v.data_ptr(), out.data_ptr(), n, int(emit == "param"),
                int(bool(adam_w)), lr, bc1, bc2, b1, b2, 1.0 - b1, 1.0 - b2, eps, wd,
                torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam launch failed: CUDA error {rc}")
    launches += 1
    return out


def fused_adam_step(p, g, m, v, *, step, lr: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0, adam_w_mode: bool = True,
                    bias_correction: bool = True, emit: str = "param",
                    out: Optional[torch.Tensor] = None):
    """One fused Adam step on flat 1-D buffers (the counterpart of the JAX
    ``fused_adam_step``, with ``emit`` exposed as the JAX optimizer uses
    it). ``step`` is the 1-based step count; m and v (fp32) are updated in
    place. Returns the new param in p's dtype (``emit="param"``, written to
    ``out`` when given, which may be ``p`` itself) or the fp32 descent
    direction ``u`` (``emit="update"``)."""
    if emit not in _EMITS:
        raise ValueError(f"emit={emit!r} (expected one of {_EMITS})")
    bc1, bc2 = bias_corrections(step, b1, b2, bias_correction)
    kw = dict(b1=float(b1), b2=float(b2), eps=float(eps), weight_decay=float(weight_decay),
              adam_w_mode=bool(adam_w_mode), emit=emit)
    if p.is_cuda:
        if out is None:
            out = torch.empty_like(p, dtype=p.dtype if emit == "param" else torch.float32)
        return _kernel(p, g, m, v, out, emit, float(lr), bc1, bc2, kw["b1"], kw["b2"],
                       kw["eps"], kw["weight_decay"], kw["adam_w_mode"])
    if p.device.type != "cpu":
        raise ValueError(f"fused_adam_step: no kernel for device {p.device}")
    res, new_m, new_v = fused_adam_plain(p, g, m, v, float(lr), bc1, bc2, **kw)
    m.copy_(new_m)
    v.copy_(new_v)
    if out is None:
        return res
    return out.copy_(res)
