"""Paged decode attention: the CUDA kernel ``csrc/paged_decode_attention.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/paged_decode_attention.py``
``_kernel``: one new query token per running request against a KV cache
kept as a pool of fixed-size blocks ``[num_blocks, block_size, KV, Hd]``
shared by every request, each request reading its blocks through its row of
``block_tables`` with its own position ``pos[b]``.

What bounds it on the H100, and what the design does about it: a decode
step does about one FLOP per K/V byte per query head of the group, far below
the bf16 ridge, so it is bound by the live K/V bytes over 3.35 TB/s. The
kernel cuts each request's keys into splits of :data:`SPLIT_KEYS` keys
spread over CTAs (flash-decoding), each CTA streaming its K/V tiles through
an asynchronous shared-memory ring and writing one fp32 partial (m, l, acc)
for all ``H // KV`` query heads of its kv group (each live byte is read once
per group); a second kernel merges a request's partials in split order, so
two launches give the same bits. The split count comes from shapes alone
(``n_max * block_size / 128``): a CTA whose splits lie past ``pos[b]``
returns at once, and the launch never reads the device.

:func:`paged_decode_attention` returns None off the kernel's envelope (as
the JAX function does), takes the plain version for CPU tensors only, and
for CUDA tensors launches the kernel or raises. ``launches`` counts calls
that launched the kernels (the split kernel and its combine: one a call). :func:`split_partials_plain` and :func:`merge_partials_plain` are
the kernel's split algorithm in plain PyTorch (``splits=`` of the plain
versions).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.kernels import build

_NEG = -1e30
#: keys of one split (one fp32 partial): ``kSplitKeys`` in ``csrc/decode_attention.cuh``
SPLIT_KEYS = 128

#: kernel launches since the last reset (set it to 0 to start counting)
launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1}
_KERNEL_GROUPS = (1, 2, 4, 8)       # H // KV values the kernel is built for
_KERNEL_HEAD_DIMS = (64, 96, 128, 256)   # and head dims


def paged_envelope_ok(H: int, KV: int, Hd: int, bs: int) -> bool:
    """Whether (heads, kv_heads, head_dim, block_size) sits inside the
    envelope of ``deepspeed_tpu``'s paged kernel, which this module keeps so
    the two packages take the same paths."""
    return H % KV == 0 and Hd % 64 == 0 and bs % 128 == 0


def split_partials_plain(s, v, width: int):
    """Per-split fp32 partials of the kernel's split algorithm: scores ``s``
    ``[B, KV, G, T]`` (keys past pos already at -1e30) and values ``v``
    ``[B, T, KV, Hd]`` cut into splits of ``width`` keys (the last padded
    with masked keys); each split's max ``m``, sum ``l`` of exp(s - m) and
    ``acc`` = sum of exp(s - m) v. Returns m, l ``[B, KV, G, S]`` and acc
    ``[B, KV, G, S, Hd]``."""
    B, KV, G, T = s.shape
    Hd = v.shape[-1]
    S = -(-T // width)
    pad = S * width - T
    if pad:
        s = F.pad(s, (0, pad), value=_NEG)
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    s = s.reshape(B, KV, G, S, width)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bcgsw,bswcd->bcgsd", p, v.reshape(B, S, width, KV, Hd))
    return m, p.sum(dim=-1), acc


def merge_partials_plain(m, l, acc, live, dtype, rescale: bool = True):
    """The combine kernel's merge: over the splits with ``live`` ``[B, S]``
    set, M = max m, then in split order L = sum l e^(m - M) and
    A = sum acc e^(m - M); returns A / L as ``[B, KV * G, Hd]`` in
    ``dtype``. ``rescale=False`` leaves out the e^(m - M) factor (a planted
    fault)."""
    B, KV, G, S = m.shape
    lv = live[:, None, None, :]
    big = torch.where(lv, m, torch.full_like(m, _NEG)).amax(dim=-1, keepdim=True)
    w = torch.exp(m - big) if rescale else torch.ones_like(m)
    w = torch.where(lv, w, torch.zeros_like(w))
    L = torch.zeros_like(m[..., 0])
    A = torch.zeros_like(acc[..., 0, :])
    for i in range(S):
        L = L + l[..., i] * w[..., i]
        A = A + acc[..., i, :] * w[..., i, None]
    return (A / L[..., None]).reshape(B, KV * G, -1).to(dtype)


def _paged_scores(q, kp, vp, block_tables, pos, pad_bias, alibi_slopes, scale):
    """fp32 scores ``[B, KV, G, n_max * bs]`` over the gathered table (keys
    past ``pos[b]`` at -1e30) and the gathered fp32 values."""
    B, H, Hd = q.shape
    Nb, bs, KV = kp.shape[0], kp.shape[1], kp.shape[2]
    G = H // KV
    scale = Hd**-0.5 if scale is None else scale
    qs = (q * scale).float().reshape(B, KV, G, Hd)
    # dead tail entries may hold anything: point them at block 0 (masked)
    live = (torch.arange(block_tables.shape[1], device=q.device)[None, :]
            <= (pos.long() // bs)[:, None])
    table = torch.where(live, block_tables.long(), 0)
    idx = (table[:, :, None] * bs
           + torch.arange(bs, device=q.device)[None, None, :]).reshape(B, -1)
    k = kp.reshape(Nb * bs, KV, Hd)[idx].float()          # [B, n*bs, KV, Hd]
    v = vp.reshape(Nb * bs, KV, Hd)[idx].float()
    s = torch.einsum("bcgd,bscd->bcgs", qs, k)
    kpos = torch.arange(idx.shape[1], device=q.device)
    rel = (kpos[None, :] - pos.long()[:, None]).float()   # [B, n*bs]
    if alibi_slopes is not None:
        s = s + alibi_slopes.float().reshape(1, KV, G, 1) * rel[:, None, None, :]
    if pad_bias is not None:
        s = s + pad_bias.float()[:, None, None, :]
    s = torch.where(rel[:, None, None, :] <= 0, s, torch.full_like(s, _NEG))
    return s, v


def paged_decode_partials_plain(q, kp, vp, block_tables, pos, pad_bias=None,
                                alibi_slopes=None, scale: Optional[float] = None,
                                splits: Optional[int] = None):
    """The kernel's per-split partials in plain PyTorch: ``splits`` splits
    (default one per :data:`SPLIT_KEYS` keys, the kernel's) of
    ``ceil(n_max * bs / splits)`` keys each. Returns m, l, acc (as
    :func:`split_partials_plain`) and ``live`` ``[B, S]``: the splits that
    start at or before ``pos[b]``."""
    s, v = _paged_scores(q, kp, vp, block_tables, pos, pad_bias, alibi_slopes, scale)
    T = s.shape[-1]
    width = -(-T // (splits or -(-T // SPLIT_KEYS)))
    m, l, acc = split_partials_plain(s, v, width)
    start = torch.arange(m.shape[-1], device=q.device) * width
    return m, l, acc, start[None, :] <= pos.long()[:, None]


def paged_decode_attention_plain(q, kp, vp, block_tables, pos, pad_bias=None,
                                 alibi_slopes=None, scale: Optional[float] = None,
                                 splits: Optional[int] = None):
    """The kernel's math in plain PyTorch: q pre-scaled in its own dtype,
    then fp32 scores over the gathered table, ALiBi and pad bias over
    logical positions, keys past ``pos[b]`` masked, natural-exp softmax.
    With ``splits`` it runs the kernel's algorithm: per-split partials
    merged in split order (:func:`paged_decode_partials_plain`); without,
    one pass over all keys."""
    if splits is not None:
        m, l, acc, live = paged_decode_partials_plain(q, kp, vp, block_tables, pos, pad_bias,
                                                      alibi_slopes, scale, splits)
        return merge_partials_plain(m, l, acc, live, q.dtype)
    B, H, Hd = q.shape
    s, v = _paged_scores(q, kp, vp, block_tables, pos, pad_bias, alibi_slopes, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bcgs,bscd->bcgd", p, v) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, H, Hd).to(q.dtype)


def _lib():
    lib = build.load("paged_decode_attention")
    fn = lib.ds_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, ref, shape, dtype):
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, q on {ref.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(fn, q, *args):
    """Call ``fn`` (a decode kernel's C entry) as ``fn(*args, stream)`` on
    q's device and its current stream (read without building a Stream
    object: the wrapper's host time is most of a decode call's)."""
    idx = q.device.index
    if idx != torch.cuda.current_device():
        with torch.cuda.device(idx):
            return _launch(fn, q, *args)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return fn(*args, raw(idx) if raw is not None else torch.cuda.current_stream(idx).cuda_stream)


def paged_decode_attention_cuda(q, kp, vp, block_tables, pos, pad_bias=None,
                                alibi_slopes=None, scale: Optional[float] = None):
    """Launch the kernels on CUDA tensors: head_dim 64, 96, 128 or 256, H / KV
    in 1, 2, 4 or 8 (the model paths keep to the envelope, Hd a multiple of
    64)."""
    global launches
    B, H, Hd = q.shape
    Nb, bs, KV = kp.shape[0], kp.shape[1], kp.shape[2]
    n_max = block_tables.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention kernel takes fp16/bf16, got {q.dtype}")
    if Hd not in _KERNEL_HEAD_DIMS or H // KV not in _KERNEL_GROUPS:
        raise ValueError(f"paged_decode_attention kernel takes head_dim 64/96/128/256 and "
                         f"H/KV in {_KERNEL_GROUPS}, got Hd={Hd}, H/KV={H // KV}")
    scale = Hd**-0.5 if scale is None else scale
    q = q.contiguous()                     # the kernel pre-scales it in q's dtype
    _check("q", q, q, (B, H, Hd), q.dtype)
    _check("kp", kp, q, (Nb, bs, KV, Hd), q.dtype)
    _check("vp", vp, q, (Nb, bs, KV, Hd), q.dtype)
    _check("block_tables", block_tables, q, (B, n_max), torch.int32)
    _check("pos", pos, q, (B,), torch.int32)
    bias = slopes = None
    if pad_bias is not None:
        bias = pad_bias.to(torch.float32).contiguous()
        _check("pad_bias", bias, q, (B, n_max * bs), torch.float32)
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).reshape(H).contiguous()
    splits = n_max * bs // SPLIT_KEYS     # bs % 128 == 0 (the envelope)
    out = torch.empty_like(q)
    part = torch.empty(B * H * splits * (Hd + 2), device=q.device, dtype=torch.float32)
    rc = _launch(_lib(), q, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                 block_tables.data_ptr(), pos.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if slopes is None else slopes.data_ptr(), out.data_ptr(),
                 part.data_ptr(), scale, B, H, KV, Hd, bs, n_max, _DTYPE_CODE[q.dtype])
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {rc}")
    launches += 1
    return out


def paged_decode_attention(q, kp, vp, block_tables, pos, *, pad_bias=None,
                           alibi_slopes=None, scale: Optional[float] = None):
    """Attention of one new token per request against a paged KV cache.

    q ``[B, H, Hd]`` (rope applied); kp/vp ``[num_blocks, block_size, KV,
    Hd]`` with each request's new k/v already written at its slot;
    ``block_tables`` ``[B, max_blocks]`` int32 pool block ids; ``pos``
    ``[B]`` int32 position of each request's new token (it attends logical
    positions ``<= pos[b]``); ``pad_bias`` ``[B, max_blocks * block_size]``
    additive f32 bias over logical positions. GQA head h reads kv head
    ``h // (H // KV)``. Returns ``[B, H, Hd]``, or None when the shape is
    outside the envelope (:func:`paged_envelope_ok`)."""
    B, H, Hd = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    if not paged_envelope_ok(H, KV, Hd, bs):
        return None
    if q.is_cuda:
        return paged_decode_attention_cuda(q, kp, vp, block_tables, pos, pad_bias,
                                           alibi_slopes, scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kp, vp, block_tables, pos, pad_bias,
                                            alibi_slopes, scale)
    raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
