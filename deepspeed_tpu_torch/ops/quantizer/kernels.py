"""Grouped fake quantization: the stochastic-rounding CUDA kernel
``csrc/sr_quantize.cu`` (TPU K8), its plain PyTorch version, and the
deterministic forms in plain PyTorch, as in
``deepspeed_tpu/ops/quantizer/kernels.py``.

A tensor is flattened to ``[groups, -1]`` and each group gets one scale:
``max|x| / qmax`` (symmetric; 1 where that is 0) or ``(max - min) / levels``
with offset ``min`` (asymmetric). Round to nearest (:func:`ds_quantize`,
:func:`ds_quantize_asym`) rounds half to even, as ``jnp.round`` does.
Stochastic rounding (:func:`ds_sr_quantize`) rounds up with probability
equal to the fractional part, so the error is unbiased in expectation.

The JAX package stacks the layers into one ``[n_layer, ...]`` leaf and its
quantizer groups that flattened leaf, so a group may span layers; the port
keeps one leaf per layer. :func:`ds_quantize_span` and
:func:`ds_sr_quantize_span` quantize a list of port leaves as the one
flattened JAX leaf they form: a group's scale is taken over its pieces in
every leaf it touches, and the kernel runs once per leaf, in place, with the
leaf's offset in the stacked view (its noise depends on the stacked index
and the seed only).

On the card a span's scales come from the group-absmax kernel of the same
source (:func:`span_scales`: one launch per leaf folding max |x| into a
``[groups]`` buffer, the last one also dividing by qmax), where the JAX
package lets XLA fuse the reduction; :func:`_span_scales` is its plain
version. Every scale is ``amax / qmax`` correctly rounded in fp32, as the
JAX package divides: a CUDA tensor divided by a Python number is multiplied
by its reciprocal instead, one ulp off for some values, so the plain forms
divide by a 0-dim tensor on the same device.

The kernel's noise is a Philox4x32-10 stream (:func:`philox_uniform` is the
same stream in PyTorch, so the card's result can be held to the plain
version bit for bit). On the CPU the plain version draws its noise from a
``torch.Generator`` seeded with ``seed`` unless ``noise`` is given; the TPU
and the JAX package off the TPU draw other bits again, so only the
distribution is shared across packages. ``launches`` counts quantization
kernel launches and ``scale_launches`` absmax kernel launches (one a leaf
each); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from deepspeed_tpu_torch.ops.kernels import build

#: quantization and absmax kernel launches since the last reset (set them to
#: 0 to start counting)
launches = 0
scale_launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
SEED_MIX = 1000003          # the TPU kernel's odd multiplicative seed hash
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------------ #
# deterministic forms (plain PyTorch; the JAX package leaves them to XLA)

def _div(x, q: float):
    """``x / q`` correctly rounded on every device: the divisor is a 0-dim
    tensor beside ``x`` (CUDA multiplies by the reciprocal of a Python
    number)."""
    return x / torch.full((), q, dtype=x.dtype, device=x.device)


def _scale_of(amax, qmax: float):
    scale = _div(amax, qmax)
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def _sym_scale(flat, bits: int):
    qmax = 2.0 ** (bits - 1) - 1
    return _scale_of(flat.abs().amax(dim=1, keepdim=True), qmax), qmax


def _asym_scale(flat, bits: int):
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    levels = 2.0 ** bits - 1
    return torch.where(hi > lo, _div(hi - lo, levels), torch.ones_like(lo)), lo, levels


def ds_quantize(x, groups: int, bits: int = 8):
    """Grouped symmetric fake quantization, round half to even."""
    flat = x.float().reshape(groups, -1)
    scale, qmax = _sym_scale(flat, bits)
    q = torch.clamp(torch.round(flat / scale), -qmax - 1, qmax)
    return (q * scale).reshape(x.shape).to(x.dtype)


def ds_quantize_asym(x, groups: int, bits: int = 8):
    """Grouped asymmetric fake quantization, round half to even."""
    flat = x.float().reshape(groups, -1)
    scale, lo, levels = _asym_scale(flat, bits)
    q = torch.clamp(torch.round((flat - lo) / scale), 0, levels)
    return (q * scale + lo).reshape(x.shape).to(x.dtype)


def _uniform(shape, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    return torch.rand(shape, generator=gen, device=device)


def ds_sr_quantize_asym(x, groups: int, bits: int = 8, seed: int = 0):
    """Asymmetric stochastic-rounding fake quantization (plain PyTorch, as
    the JAX package keeps it in jnp)."""
    flat = x.float().reshape(groups, -1)
    scale, lo, levels = _asym_scale(flat, bits)
    u = _uniform(flat.shape, seed, flat.device)
    q = torch.clamp(torch.floor((flat - lo) / scale + u), 0, levels)
    return (q * scale + lo).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ #
# stochastic rounding: the kernel's noise stream and the plain version

def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 tensors of 32-bit
    values, without overflowing int64."""
    t1 = (a & 0xFFFF) * m
    t2 = (a >> 16) * m
    lo = (((t2 & 0xFFFF) << 16) + t1) & _MASK32
    hi = ((t2 + (t1 >> 16)) >> 16) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) over int64 tensors holding 32-bit
    counter words; returns the four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_key(seed: int):
    """The kernel's Philox key for a seed: the seed times the TPU kernel's
    mixing constant, as two 32-bit words."""
    mixed = (int(seed) * SEED_MIX) & (2**64 - 1)
    return mixed & _MASK32, (mixed >> 32) & _MASK32


def philox_words(seed: int, offset: int, n: int, device="cpu", counter_mod: int = 0):
    """The kernel's 32-bit draw (as int64) for each stacked index in
    ``[offset, offset + n)``: word ``index % 4`` of the Philox output for
    counter ``index // 4``. ``counter_mod`` > 0 restarts the counter every
    that many quads (a planted fault: one stream per block)."""
    k0, k1 = philox_key(seed)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    quad = idx >> 2
    if counter_mod:
        quad = quad % counter_mod
    zero = torch.zeros_like(quad)
    words = torch.stack(philox4x32_10(quad & _MASK32, quad >> 32, zero, zero, k0, k1))
    return words.gather(0, (idx & 3)[None]).squeeze(0)


def philox_uniform(seed: int, offset: int, n: int, device="cpu", counter_mod: int = 0):
    """The kernel's noise for stacked indices ``[offset, offset + n)``: the
    low 24 bits of each draw times 2^-24, uniform in [0, 1)."""
    word = philox_words(seed, offset, n, device, counter_mod)
    return (word & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def sr_quantize_plain(x, scale, qmax: float, noise):
    """The kernel's arithmetic: ``clamp(floor(x / s + u), -qmax - 1, qmax) *
    s`` in fp32, rounded to x's dtype. ``x`` and ``noise`` are ``[G, L]``,
    ``scale`` is ``[G, 1]``."""
    q = torch.clamp(torch.floor(x.float() / scale + noise), -qmax - 1, qmax)
    return (q * scale).to(x.dtype)


def _check(x, **others):
    """Dtype, contiguity and device of a kernel's tensors (``others`` on
    ``x``'s device)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"sr_quantize takes fp16 / bf16 / fp32, got {x.dtype}")
    for name, t in (("x", x), *others.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _lib_fn(name: str, argtypes):
    fn = getattr(build.load("sr_quantize"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int


def _kernel(x, out, scale, group_size: int, offset: int, qmax: float, seed: int):
    global launches
    n = x.numel()
    _check(x, out=out, scale=scale)
    if out.dtype != x.dtype:
        raise TypeError(f"sr_quantize takes fp16 / bf16 / fp32, got {x.dtype} -> {out.dtype}")
    if out.numel() != n or scale.dtype != torch.float32:
        raise ValueError("out must match x, scale must be fp32")
    fn = _lib_fn("ds_sr_quantize", [_P, _P, _I, _L, _L, _L, _P, ctypes.c_float, ctypes.c_uint,
                                    ctypes.c_uint, _P])
    k0, k1 = philox_key(seed)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], n, offset, group_size,
                scale.data_ptr(), qmax, k0, k1, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sr_quantize launch failed: CUDA error {rc}")
    launches += 1
    return out


def span_scales(leaves: Sequence[torch.Tensor], groups: int, bits: int):
    """Per-group symmetric scales ``[groups]`` (fp32) of the flattened
    concatenation of ``leaves``: ``max|x| / qmax`` over each group, 1 where
    that is 0; returns ``(scale, qmax, group_size)``. On the card the absmax
    kernel runs once per leaf (the first call zeroes the buffer, the last
    divides by qmax); on the CPU :func:`_span_scales`."""
    global scale_launches
    leaves = list(leaves)
    if leaves[0].device.type != "cuda":
        return _span_scales(leaves, groups, bits)
    gs = _group_size(leaves, groups)
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.empty(groups, dtype=torch.float32, device=leaves[0].device)
    fn = _lib_fn("ds_sr_absmax", [_P, _I, _L, _L, _L, _P, _L, _I, _I, ctypes.c_float, _P])
    off = 0
    with torch.cuda.device(scale.device):
        stream = torch.cuda.current_stream(scale.device).cuda_stream
        for i, t in enumerate(leaves):
            _check(t, scale=scale)
            rc = fn(t.data_ptr(), _DTYPE_CODE[t.dtype], t.numel(), off, gs, scale.data_ptr(),
                    groups, i == 0, i == len(leaves) - 1, qmax, stream)
            if rc != 0:
                raise RuntimeError(f"sr_absmax launch failed: CUDA error {rc}")
            scale_launches += 1
            off += t.numel()
    return scale, qmax, gs


def ds_sr_quantize(x, groups: int, bits: int = 8, seed: int = 0,
                   noise: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None):
    """Grouped symmetric fake quantization with stochastic rounding. On a
    CUDA tensor: the kernel (``noise`` must be None; ``out`` may be ``x``
    for in place). On the CPU: the plain version, with ``noise`` (the
    ``[groups, -1]`` uniform draws) or a ``torch.Generator`` seeded with
    ``seed``."""
    return ds_sr_quantize_span([x], groups, bits, seed, noise=noise,
                               out=None if out is None else [out])[0]


def _group_size(leaves, groups: int) -> int:
    total = sum(t.numel() for t in leaves)
    if total % groups:
        raise ValueError(f"cannot reshape {total} elements into {groups} groups")
    return total // groups


def _span_scales(leaves: Sequence[torch.Tensor], groups: int, bits: int):
    """:func:`span_scales` in plain PyTorch on any device: each leaf's group
    pieces reduced by torch ``amax``, the division correctly rounded."""
    gs = _group_size(leaves, groups)
    amax = torch.zeros(groups, dtype=torch.float32, device=leaves[0].device)
    off = 0
    for t in leaves:
        flat = t.reshape(-1)
        n = flat.numel()
        e = 0
        while e < n:                       # one piece per group the leaf touches
            g0 = (off + e) // gs
            if (off + e) % gs == 0 and n - e >= gs:     # whole groups in one reduction
                k = (n - e) // gs
                part = flat[e:e + k * gs].float().reshape(k, gs).abs().amax(dim=1)
                amax[g0:g0 + k] = torch.maximum(amax[g0:g0 + k], part)
                e += k * gs
            else:
                end = min(n, (g0 + 1) * gs - off)
                amax[g0] = torch.maximum(amax[g0], flat[e:end].float().abs().amax())
                e = end
        off += n
    qmax = 2.0 ** (bits - 1) - 1
    return _scale_of(amax, qmax), qmax, gs


def ds_sr_quantize_span(leaves: Sequence[torch.Tensor], groups: int, bits: int = 8,
                        seed: int = 0, noise: Optional[torch.Tensor] = None,
                        out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """:func:`ds_sr_quantize` of the flattened concatenation of ``leaves``
    (one JAX leaf stored as per-layer port leaves), returned as one tensor
    per leaf (``out``: where to write them; may be ``leaves`` itself).
    CUDA tensors run the absmax kernel, then the quantization kernel,
    once per leaf each."""
    leaves = list(leaves)
    dev = leaves[0].device
    if dev.type == "cuda":
        if noise is not None:
            raise ValueError("the kernel draws its own noise (Philox); noise= is for the "
                             "plain version")
        scale, qmax, gs = span_scales(leaves, groups, bits)
        out = out if out is not None else [torch.empty_like(t) for t in leaves]
        off = 0
        for t, o in zip(leaves, out):
            _kernel(t, o, scale, gs, off, qmax, seed)
            off += t.numel()
        return out
    if dev.type != "cpu":
        raise ValueError(f"ds_sr_quantize: no kernel for device {dev}")
    flat = torch.cat([t.reshape(-1).float() for t in leaves]).reshape(groups, -1)
    scale, qmax = _sym_scale(flat, bits)
    if noise is None:
        noise = _uniform(flat.shape, seed, dev)
    q = sr_quantize_plain(flat, scale, qmax, noise.reshape(flat.shape))
    return _split(q.reshape(-1), leaves, out)


def _split(flat, leaves, out):
    res, off = [], 0
    for i, t in enumerate(leaves):
        piece = flat[off:off + t.numel()].reshape(t.shape).to(t.dtype)
        res.append(out[i].copy_(piece) if out is not None else piece)
        off += t.numel()
    return res


def ds_quantize_span(fn, leaves: Sequence[torch.Tensor], *args,
                     out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """``fn(stacked, *args)`` (a plain quantizer of this module, or the
    runtime's ternary / binary) over the flattened concatenation of
    ``leaves``, split back into one tensor per leaf."""
    leaves = list(leaves)
    flat = leaves[0].reshape(-1) if len(leaves) == 1 else torch.cat([t.reshape(-1)
                                                                     for t in leaves])
    return _split(fn(flat, *args).reshape(-1), leaves, out)
