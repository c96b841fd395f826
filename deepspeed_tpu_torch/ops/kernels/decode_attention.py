"""Dense decode attention: the CUDA kernel ``csrc/dense_decode_attention.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/decode_attention.py``
``_kernel`` (K5): one new query token per batch row against the dense KV
workspace ``[B, Smax, KV, Hd]`` of static generation, with one position
``pos`` for the whole batch (keys past it masked), an optional additive pad
bias ``[B, Smax]`` and ALiBi slopes.

What bounds it on the H100, and what the design does about it: a decode
step does about one FLOP per K/V byte per query head of the group, far below
the bf16 ridge, so it is bound by the live K/V bytes over 3.35 TB/s. The
live prefix ``[0, pos]`` of every row is cut into ``pos // 128 + 1`` splits
of 128 keys spread over CTAs, each streaming its K/V tiles through an
asynchronous shared-memory ring for all ``H // KV`` query heads of its kv
group (each live byte is read once per group) and writing one fp32 partial;
a second kernel merges each row's partials in split order. The device body
is shared with the paged kernel (``csrc/decode_attention.cuh``).

:func:`decode_attention` returns None off the JAX kernel's envelope (so both
packages take the same path), takes the plain version for CPU tensors only,
and for CUDA tensors launches the kernel or raises. ``pos`` is a host int, so
the split count is known on the host. ``launches`` counts calls that
launched the kernels (the split kernel and its combine: one a call).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import build
# the two decode kernels share one device body, so one set of instantiations
from deepspeed_tpu_torch.ops.kernels.paged_decode_attention import (SPLIT_KEYS, _DTYPE_CODE,
                                                                    _KERNEL_GROUPS,
                                                                    _KERNEL_HEAD_DIMS, _check,
                                                                    _launch,
                                                                    merge_partials_plain,
                                                                    split_partials_plain)

_NEG = -1e30

#: kernel launches since the last reset (set it to 0 to start counting)
launches = 0


def dense_envelope_ok(H: int, KV: int, Hd: int, Smax: int) -> bool:
    """Whether (heads, kv_heads, head_dim, Smax) sits inside the envelope of
    ``deepspeed_tpu``'s decode kernel, which this module keeps."""
    return H % KV == 0 and Hd % 64 == 0 and Smax % 128 == 0


def decode_partials_plain(q, ck, cv, pos: int, pad_bias=None, alibi_slopes=None,
                          scale: Optional[float] = None, splits: Optional[int] = None):
    """The kernel's per-split partials in plain PyTorch: ``splits`` splits
    (default one per :data:`SPLIT_KEYS` keys of ``Smax``, the kernel's, whose
    splits past ``pos`` it never launches) of ``ceil(Smax / splits)`` keys.
    Returns m, l, acc (as :func:`split_partials_plain`) and ``live``
    ``[B, S]``: the splits that start at or before ``pos``."""
    B, H, Hd = q.shape
    Smax, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    scale = Hd**-0.5 if scale is None else scale
    qs = (q * scale).float().reshape(B, KV, G, Hd)
    s = torch.einsum("bcgd,bscd->bcgs", qs, ck.float())
    rel = (torch.arange(Smax, device=q.device) - pos).float()
    if alibi_slopes is not None:
        s = s + alibi_slopes.float().reshape(1, KV, G, 1) * rel
    if pad_bias is not None:
        s = s + pad_bias.float()[:, None, None, :]
    s = torch.where(rel <= 0, s, torch.full_like(s, _NEG))
    width = -(-Smax // (splits or -(-Smax // SPLIT_KEYS)))
    m, l, acc = split_partials_plain(s, cv.float(), width)
    live = (torch.arange(m.shape[-1], device=q.device) * width <= pos)[None, :].expand(B, -1)
    return m, l, acc, live


def decode_attention_plain(q, ck, cv, pos: int, pad_bias=None, alibi_slopes=None,
                           scale: Optional[float] = None, splits: Optional[int] = None):
    """The kernel's math in plain PyTorch: q pre-scaled in its own dtype,
    then fp32 scores over the live keys ``[0, pos]`` (the masked tail adds
    exactly zero), ALiBi and pad bias over key positions, natural-exp
    softmax, output in q's dtype. With ``splits`` it runs the kernel's
    algorithm: per-split partials merged in split order
    (:func:`decode_partials_plain`); without, one pass over the live keys."""
    if splits is not None:
        m, l, acc, live = decode_partials_plain(q, ck, cv, pos, pad_bias, alibi_slopes, scale,
                                                splits)
        return merge_partials_plain(m, l, acc, live, q.dtype)
    B, H, Hd = q.shape
    KV = ck.shape[2]
    G = H // KV
    n = pos + 1
    scale = Hd**-0.5 if scale is None else scale
    qs = (q * scale).float().reshape(B, KV, G, Hd)
    s = torch.einsum("bcgd,bscd->bcgs", qs, ck[:, :n].float())
    if alibi_slopes is not None:
        rel = (torch.arange(n, device=q.device) - pos).float()
        s = s + alibi_slopes.float().reshape(1, KV, G, 1) * rel
    if pad_bias is not None:
        s = s + pad_bias[:, :n].float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True).clamp(min=_NEG)
    p = torch.exp(s - m)
    o = torch.einsum("bcgs,bscd->bcgd", p, cv[:, :n].float()) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, H, Hd).to(q.dtype)


def _lib():
    fn = build.load("dense_decode_attention").ds_dense_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, ck, cv, pos: int, pad_bias=None, alibi_slopes=None,
                          scale: Optional[float] = None):
    """Launch the kernels on CUDA tensors: head_dim 64, 96, 128 or 256, H / KV
    in 1, 2, 4 or 8 (the model paths keep to the envelope, Hd a multiple of
    64)."""
    global launches
    B, H, Hd = q.shape
    Smax, KV = ck.shape[1], ck.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention kernel takes fp16/bf16, got {q.dtype}")
    if Hd not in _KERNEL_HEAD_DIMS or H // KV not in _KERNEL_GROUPS:
        raise ValueError(f"decode_attention kernel takes head_dim 64/96/128/256 and "
                         f"H/KV in {_KERNEL_GROUPS}, got Hd={Hd}, H/KV={H // KV}")
    if not 0 <= pos < Smax:
        raise ValueError(f"pos {pos} outside the cache [0, {Smax})")
    scale = Hd**-0.5 if scale is None else scale
    q = q.contiguous()                     # the kernel pre-scales it in q's dtype
    _check("q", q, q, (B, H, Hd), q.dtype)
    _check("ck", ck, q, (B, Smax, KV, Hd), q.dtype)
    _check("cv", cv, q, (B, Smax, KV, Hd), q.dtype)
    bias = slopes = None
    if pad_bias is not None:
        bias = pad_bias.to(torch.float32).contiguous()
        _check("pad_bias", bias, q, (B, Smax), torch.float32)
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).reshape(H).contiguous()
    splits = pos // SPLIT_KEYS + 1
    out = torch.empty_like(q)
    part = torch.empty(B * H * splits * (Hd + 2), device=q.device, dtype=torch.float32)
    rc = _launch(_lib(), q, q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if slopes is None else slopes.data_ptr(), out.data_ptr(),
                 part.data_ptr(), scale, B, H, KV, Hd, Smax, pos, _DTYPE_CODE[q.dtype])
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    launches += 1
    return out


def decode_attention(q, ck, cv, pos: int, *, pad_bias=None, alibi_slopes=None,
                     scale: Optional[float] = None):
    """Attention of one new token per row against the dense KV cache.

    q ``[B, H, Hd]`` (rope applied); ck/cv ``[B, Smax, KV, Hd]`` with the new
    k/v already written at ``pos``; ``pos`` the new token's 0-based position
    (a host int; it attends ``<= pos``); ``pad_bias`` ``[B, Smax]`` additive
    f32. GQA head h reads kv head ``h // (H // KV)``. Returns ``[B, H, Hd]``,
    or None when the shape is outside the envelope
    (:func:`dense_envelope_ok`)."""
    B, H, Hd = q.shape
    Smax, KV = ck.shape[1], ck.shape[2]
    if not dense_envelope_ok(H, KV, Hd, Smax):
        return None
    pos = int(pos)
    if q.is_cuda:
        return decode_attention_cuda(q, ck, cv, pos, pad_bias, alibi_slopes, scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, pos, pad_bias, alibi_slopes, scale)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")
