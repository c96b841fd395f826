"""Flash attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version.

Replaces the TPU kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``
on the forward path: ``_fwd_kernel`` (the general kernel, GQA and Hd = 128)
and ``_packed_fwd_kernel`` (packed heads for MHA with Hd < 128, e.g. GPT-2's
64). The Hopper kernel reads ``[B, S, H, Hd]`` in place for both, so one
kernel covers the two call sites.

What bounds it on the H100, and what the simple design does about it: at
prefill lengths attention is memory-bound on the q/k/v/o bytes (it reaches
the bf16 ridge of about 295 FLOP/byte only near S = 1000 at Hd = 128). The
kernel never writes the S x S scores, reads each q tile once, streams k/v
tiles only up to the causal diagonal, and keeps the running softmax in fp32
registers; its k/v tiles are re-read once per q tile, from L2. See the
source's header for the layout.

:func:`flash_attention` takes the plain version for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches (the serving path's proof that it ran the kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import build

_MASKED = -1e30
_LOG2E = 1.4426950408889634

#: kernel launches since the last reset (set it to 0 to start counting)
launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, mask_bias=None, causal: bool = True,
                          alibi_slopes=None, scale: Optional[float] = None):
    """The kernel's math in plain PyTorch, fp32 throughout: log2-domain
    logits with the same masking conventions, p rounded to v's dtype before
    the P V product, and the log2-domain lse ``[B, H, S]``. Returns
    ``(out [B, S, H, Hd] in q's dtype, lse)``."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = float(scale if scale is not None else Hd**-0.5)
    q5 = q.float().reshape(B, S, KV, G, Hd)
    s = torch.einsum("bqcgd,bkcd->bcgqk", q5, k.float()) * (scale * _LOG2E)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(KV, G, 1, 1) * _LOG2E
        bias = slopes * (kpos - qpos).float()
    else:
        bias = torch.zeros((1, 1, S, S), device=q.device)
    if causal:
        bias = torch.where(qpos >= kpos, bias, torch.full_like(bias, _MASKED))
    s = s + bias
    if mask_bias is not None:
        s = s + mask_bias.float()[:, None, None, None, :] * _LOG2E
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bcgqk,bkcd->bqcgd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = o / safe_l.permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m + torch.log2(safe_l), torch.full_like(l, -_MASKED))
    return o.reshape(B, S, H, Hd).to(q.dtype), lse.reshape(B, H, S)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.ds_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, ref, shape):
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, q on {ref.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention_cuda(q, k, v, mask_bias=None, causal: bool = True,
                         alibi_slopes=None, scale: Optional[float] = None):
    """Launch the kernel on CUDA tensors. Returns ``(out, lse)``."""
    global launches
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes fp16/bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if Hd not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, got {Hd}")
    _check("q", q, q, (B, S, H, Hd))
    _check("k", k, q, (B, S, KV, Hd))
    _check("v", v, q, (B, S, KV, Hd))
    mask = slopes = None
    if mask_bias is not None:
        mask = mask_bias.to(torch.float32).contiguous()
        _check("mask_bias", mask, q, (B, S))
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).reshape(H).contiguous()
    scale = float(scale if scale is not None else Hd**-0.5)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if slopes is None else slopes.data_ptr(),
                B, S, H, KV, Hd, int(bool(causal)), scale * _LOG2E,
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    launches += 1
    return o, lse


def flash_attention(q, k, v, mask_bias=None, causal: bool = True, alibi_slopes=None,
                    scale: Optional[float] = None, block_layout=None,
                    return_lse: bool = False):
    """Flash attention on ``[B, S, H, Hd]`` q and ``[B, S, KV, Hd]`` k/v
    (query head h reads kv head ``h // (H // KV)``); ``mask_bias`` is an
    additive key-side ``[B, S]`` bias, ``alibi_slopes`` ``[H]``. The
    counterpart of ``deepspeed_tpu.ops.pallas.flash_attention`` (forward
    only; the kernel's tiles are fixed, so there are no block-size knobs).
    ``return_lse=True`` returns ``(out, lse)`` with lse the log2-domain
    logsumexp ``[B, H, S]``. The block-sparse ``block_layout`` belongs to
    the sparse-attention slice and is refused."""
    B, S, H, Hd = q.shape
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    if block_layout is not None:
        raise NotImplementedError(
            "block-sparse flash attention (block_layout) is not ported yet: "
            "ROADMAP.md queue 1, sparse attention")
    if q.is_cuda:
        o, lse = flash_attention_cuda(q, k, v, mask_bias, causal, alibi_slopes, scale)
    elif q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, mask_bias, causal, alibi_slopes, scale)
    else:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return (o, lse) if return_lse else o
