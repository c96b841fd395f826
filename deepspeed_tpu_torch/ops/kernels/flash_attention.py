"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` (kernel
A, forward) and ``csrc/flash_attention_bwd.cu`` (kernels C and D, the
backward's dq and dk/dv), and their plain PyTorch versions.

Replaces the TPU kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
``_fwd_kernel`` / ``_dq_kernel`` / ``_dkv_kernel`` (the general kernels, GQA
and Hd = 128) and their packed-heads twins ``_packed_*_kernel`` (MHA with
Hd < 128, e.g. GPT-2's 64). The Hopper kernels read ``[B, S, H, Hd]`` in
place for both, so one kernel covers each pair of call sites.

What bounds them on the H100, and what the simple design does about it: at
prefill lengths the forward is memory-bound on the q/k/v/o bytes (it reaches
the bf16 ridge of about 295 FLOP/byte only near S = 1000 at Hd = 128); the
backward at training lengths does 3 (dq) and 4 (dk, dv) S x S x Hd products
and is compute-bound. None of the kernels writes an S x S tile: the forward
keeps its running softmax in fp32 registers and writes the log2-domain lse,
from which the backward recomputes p. See the sources' headers for the
layouts.

:func:`flash_attention` is differentiable: its autograd Function saves
``(q, k, v, o, lse, mask, slopes)``, computes ``delta = sum(do * o)`` in fp32
with plain torch (as the JAX package does in XLA) and runs C and D. Each
wrapper takes the plain version for CPU tensors only; for a CUDA tensor it
launches its kernel or raises. ``launches``, ``dq_launches`` and
``dkv_launches`` count kernel launches of A, C and D (a run's proof that it
went through them).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import build

_MASKED = -1e30
_LOG2E = 1.4426950408889634

#: kernel launches since the last reset (set them to 0 to start counting):
#: A (forward), C (dq) and D (dk, dv)
launches = 0
dq_launches = 0
dkv_launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1}


def _log2_logits(q, k, mask_bias, causal: bool, alibi_slopes, scale: float):
    """The kernels' log2-domain logits ``[B, KV, G, S, S]`` in fp32: scaled
    q k^T with ALiBi, -1e30 above the causal diagonal, plus the key-side
    mask bias (the TPU kernels' ``_block_bias``)."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
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
    return s


def _scale(q, scale):
    return float(scale if scale is not None else q.shape[-1]**-0.5)


def flash_attention_plain(q, k, v, mask_bias=None, causal: bool = True,
                          alibi_slopes=None, scale: Optional[float] = None):
    """Kernel A's math in plain PyTorch, fp32 throughout: log2-domain
    logits with the same masking conventions (the running max starts at
    -1e30, so a row whose every logit is at or below it has no mass), p
    rounded to v's dtype before the P V product, and the log2-domain lse
    ``[B, H, S]`` (+1e30 for a row with no mass). Returns ``(out [B, S, H,
    Hd] in q's dtype, lse)``."""
    B, S, H, Hd = q.shape
    s = _log2_logits(q, k, mask_bias, causal, alibi_slopes, _scale(q, scale))
    m = s.amax(dim=-1, keepdim=True).clamp(min=_MASKED)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bcgqk,bkcd->bqcgd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = o / safe_l.permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m + torch.log2(safe_l), torch.full_like(l, -_MASKED))
    return o.reshape(B, S, H, Hd).to(q.dtype), lse.reshape(B, H, S)


def _p_and_ds_terms(q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, scale):
    """p = exp2(s - lse) ``[B, KV, G, Sq, Sk]`` and dp - delta, both fp32."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    s = _log2_logits(q, k, mask_bias, causal, alibi_slopes, scale)
    p = torch.exp2(s - lse.float().reshape(B, KV, G, S, 1))
    do5 = do.float().reshape(B, S, KV, G, Hd)
    dp = torch.einsum("bqcgd,bkcd->bcgqk", do5, v.float())
    return p, dp - delta.float().reshape(B, KV, G, S, 1)


def flash_attention_dq_plain(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                             alibi_slopes=None, scale: Optional[float] = None):
    """Kernel C's math (the TPU ``_dq_kernel``) in plain PyTorch: p stays
    fp32, ``ds = p (dp - delta) scale`` is rounded to k's dtype, ``dq = ds
    k`` accumulates in fp32 and comes back in q's dtype ``[B, S, H, Hd]``.
    ``lse`` / ``delta`` are ``[B, H, S]`` fp32 (lse log2-domain, from the
    forward; delta = sum(do * o) over Hd)."""
    B, S, H, Hd = q.shape
    sc = _scale(q, scale)
    p, dpd = _p_and_ds_terms(q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, sc)
    ds = (p * dpd * sc).to(k.dtype).float()
    dq = torch.einsum("bcgqk,bkcd->bqcgd", ds, k.float())
    return dq.reshape(B, S, H, Hd).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                              alibi_slopes=None, scale: Optional[float] = None):
    """Kernel D's math (the TPU ``_dkv_kernel``) in plain PyTorch: p is
    rounded to do's dtype and that p feeds both ``dv = p^T do`` and ``ds =
    p (dp - delta) scale``, which is rounded to q's dtype for ``dk = ds^T
    q``; both sum over the G query heads of each kv group in fp32 and come
    back in q's dtype ``[B, S, KV, Hd]``."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    sc = _scale(q, scale)
    p, dpd = _p_and_ds_terms(q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, sc)
    p = p.to(do.dtype).float()
    ds = (p * dpd * sc).to(q.dtype).float()
    dv = torch.einsum("bcgqk,bqcgd->bkcd", p, do.float().reshape(B, S, KV, G, Hd))
    dk = torch.einsum("bcgqk,bqcgd->bkcd", ds, q.float().reshape(B, S, KV, G, Hd))
    return dk.to(q.dtype), dv.to(q.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(library: str, symbol: str, argtypes):
    fn = getattr(build.load(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, ref, shape, dtype=None):
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, q on {ref.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)}, expected {tuple(shape)}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_inputs(q, k, v, mask_bias, alibi_slopes):
    """Check what every kernel of this module takes; returns the fp32 mask
    and slopes (or None) on q's device."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernels take fp16/bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if Hd not in (64, 128):
        raise ValueError(f"flash_attention kernels take head_dim 64 or 128, got {Hd}")
    _check("q", q, q, (B, S, H, Hd))
    _check("k", k, q, (B, S, KV, Hd))
    _check("v", v, q, (B, S, KV, Hd))
    mask = slopes = None
    if mask_bias is not None:
        mask = mask_bias.to(torch.float32).contiguous()
        _check("mask_bias", mask, q, (B, S))
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).reshape(H).contiguous()
    return mask, slopes


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(fn, name, q, *args):
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def flash_attention_cuda(q, k, v, mask_bias=None, causal: bool = True,
                         alibi_slopes=None, scale: Optional[float] = None):
    """Launch kernel A on CUDA tensors. Returns ``(out, lse)``."""
    global launches
    B, S, H, Hd = q.shape
    mask, slopes = _kernel_inputs(q, k, v, mask_bias, alibi_slopes)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _bind("flash_attention", "ds_flash_attention_fwd", [_P] * 7 + [_I] * 6 + [_F, _I, _P])
    _launch(fn, "flash_attention_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _ptr(mask), _ptr(slopes), B, S, H, k.shape[2], Hd,
            int(bool(causal)), _scale(q, scale) * _LOG2E, _DTYPE_CODE[q.dtype])
    launches += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta, mask_bias, alibi_slopes):
    mask, slopes = _kernel_inputs(q, k, v, mask_bias, alibi_slopes)
    B, S, H, _ = q.shape
    _check("do", do, q, q.shape, q.dtype)
    _check("lse", lse, q, (B, H, S), torch.float32)
    _check("delta", delta, q, (B, H, S), torch.float32)
    return mask, slopes


def flash_attention_dq_cuda(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                            alibi_slopes=None, scale: Optional[float] = None):
    """Launch kernel C on CUDA tensors. Returns dq ``[B, S, H, Hd]``."""
    global dq_launches
    B, S, H, Hd = q.shape
    mask, slopes = _bwd_inputs(q, k, v, do, lse, delta, mask_bias, alibi_slopes)
    dq = torch.empty_like(q)
    sc = _scale(q, scale)
    fn = _bind("flash_attention_bwd", "ds_flash_attention_bwd_dq",
               [_P] * 9 + [_I] * 6 + [_F, _F, _I, _P])
    _launch(fn, "flash_attention_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(slopes),
            dq.data_ptr(), B, S, H, k.shape[2], Hd, int(bool(causal)), sc * _LOG2E, sc,
            _DTYPE_CODE[q.dtype])
    dq_launches += 1
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                             alibi_slopes=None, scale: Optional[float] = None):
    """Launch kernel D on CUDA tensors. Returns ``(dk, dv)`` ``[B, S, KV, Hd]``."""
    global dkv_launches
    B, S, H, Hd = q.shape
    mask, slopes = _bwd_inputs(q, k, v, do, lse, delta, mask_bias, alibi_slopes)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sc = _scale(q, scale)
    fn = _bind("flash_attention_bwd", "ds_flash_attention_bwd_dkv",
               [_P] * 10 + [_I] * 6 + [_F, _F, _I, _P])
    _launch(fn, "flash_attention_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(slopes),
            dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], Hd, int(bool(causal)),
            sc * _LOG2E, sc, _DTYPE_CODE[q.dtype])
    dkv_launches += 1
    return dk, dv


def _dispatch(cuda_fn, plain_fn, name, q, *args):
    """The kernel for CUDA tensors, the plain version for CPU tensors only."""
    if q.is_cuda:
        return cuda_fn(q, *args)
    if q.device.type == "cpu":
        return plain_fn(q, *args)
    raise ValueError(f"{name}: no kernel for device {q.device}")


def flash_attention_dq(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                       alibi_slopes=None, scale: Optional[float] = None):
    """dq of flash attention from the forward's lse and ``delta = sum(do *
    o)``: kernel C on the card, :func:`flash_attention_dq_plain` on the CPU."""
    return _dispatch(flash_attention_dq_cuda, flash_attention_dq_plain, "flash_attention_dq",
                     q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, scale)


def flash_attention_dkv(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                        alibi_slopes=None, scale: Optional[float] = None):
    """(dk, dv) of flash attention, summed over each kv group: kernel D on
    the card, :func:`flash_attention_dkv_plain` on the CPU."""
    return _dispatch(flash_attention_dkv_cuda, flash_attention_dkv_plain,
                     "flash_attention_dkv", q, k, v, do, lse, delta, mask_bias, causal,
                     alibi_slopes, scale)


def _forward(q, k, v, mask_bias, causal, alibi_slopes, scale):
    return _dispatch(flash_attention_cuda, flash_attention_plain, "flash_attention",
                     q, k, v, mask_bias, causal, alibi_slopes, scale)


class _FlashAttention(torch.autograd.Function):
    """Kernel A forward; kernels C and D backward (the TPU package's
    ``jax.custom_vjp`` around ``_fwd_kernel`` / ``_dq_kernel`` /
    ``_dkv_kernel``). The forward reads nothing but its inputs, so a
    rematerialising checkpoint recomputes exactly the saved o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask_bias, alibi_slopes, causal, scale):
        o, lse = _forward(q, k, v, mask_bias, causal, alibi_slopes, scale)
        ctx.save_for_backward(q, k, v, o, lse, mask_bias, alibi_slopes)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask_bias, slopes = ctx.saved_tensors
        do = do.contiguous()
        # delta in fp32 with plain torch, as the JAX package does in XLA
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, mask_bias, ctx.causal, slopes, ctx.scale)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask_bias=None, causal: bool = True, alibi_slopes=None,
                    scale: Optional[float] = None, block_layout=None,
                    return_lse: bool = False):
    """Flash attention on ``[B, S, H, Hd]`` q and ``[B, S, KV, Hd]`` k/v
    (query head h reads kv head ``h // (H // KV)``); ``mask_bias`` is an
    additive key-side ``[B, S]`` bias, ``alibi_slopes`` ``[H]``. The
    counterpart of ``deepspeed_tpu.ops.pallas.flash_attention`` (the
    kernels' tiles are fixed, so there are no block-size knobs), and
    differentiable in q, k and v through kernels C and D.
    ``return_lse=True`` returns ``(out, lse)`` with lse the log2-domain
    logsumexp ``[B, H, S]``; it is forward-only here (its gradient serves
    ring attention, not ported). The block-sparse ``block_layout`` belongs
    to the sparse-attention slice and is refused."""
    H = q.shape[2]
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    if block_layout is not None:
        raise NotImplementedError(
            "block-sparse flash attention (block_layout) is not ported yet: "
            "ROADMAP.md queue 1, sparse attention")
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if return_lse:
        if needs_grad:
            raise NotImplementedError(
                "a differentiable return_lse (ring attention) is not ported yet: "
                "ROADMAP.md queue 1, sequence/")
        return _forward(q, k, v, mask_bias, causal, alibi_slopes, scale)
    if needs_grad:
        return _FlashAttention.apply(q, k, v, mask_bias, alibi_slopes, causal, scale)
    return _forward(q, k, v, mask_bias, causal, alibi_slopes, scale)[0]
