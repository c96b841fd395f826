"""Fused logits-free cross-entropy of the vocab head: the CUDA kernels
``csrc/fused_cross_entropy.cu`` and their plain PyTorch versions.

Replaces the TPU kernels of ``deepspeed_tpu/ops/pallas/fused_cross_entropy.py``:
``_fwd_kernel`` (per-token nll and log2-domain lse without forming the
``[N, V]`` logits), ``_dh_kernel`` and ``_dw_kernel`` (the backward,
recomputing the logits from the saved lse). On Hopper the work splits into
four launches, each with its own counter:

- **F** :func:`fused_ce_fwd` (``fwd_launches``): nll and lse ``[N]``;
- **G** :func:`fused_ce_ds` (``ds_launches``): ``ds = (exp2(s - lse) -
  onehot) * coef`` once, in h's dtype, ``[N, V]``, and ``db = sum_t ds`` in
  fp32 when there is a bias;
- :func:`fused_ce_dh` (``dh_launches``): ``dh = ds W^T``;
- :func:`fused_ce_dw` (``dw_launches``): ``dW = h^T ds``.

All four run on a Hopper mainloop (``csrc/wgmma_gemm.cuh``): TMA loads into
a ring of shared-memory stages guarded by mbarriers, and wgmma products with
fp32 register accumulators. F folds each 128 x 256 logits tile from the
accumulator registers into one (max, sum, gold) partial per token and vocab
tile; a second launch combines a token's partials in order
(:func:`fused_ce_fwd_tiles_plain` and :func:`fused_ce_combine_plain` are
that schedule in plain PyTorch). What bounds them on the H100, what the
designs do about it, and why the TPU kernels' VMEM accumulators do not carry
over: see the source's header. The backward holds ds (N x V x 2 bytes, 0.52
GB at N 8192, V 32000) where the plain vocab-head path holds about 2.5 GB
of logits and softmax.

Each operand is read as it lies in memory, K-major or MN-major
(:func:`ds_operands` for F and G, :func:`dh_operands`, :func:`dw_operands`,
decided from shapes and strides, so the CPU tests check them). A tied head
(``W = embed.T``, stored ``[V, D]``) is read in place, and its gradient
comes back as the transpose of a ``[V, D]`` tensor. TMA needs row strides
that are multiples of 8 elements: an operand without one (an untied W with
V = 50257, h with D % 8 != 0) is copied into padded rows (:func:`_tma_rows`);
:class:`_FusedCE` copies h and W once in the forward and keeps the copies
for the backward.

:func:`fused_cross_entropy` is the counterpart of the JAX function: the
per-token nll goes through a ``torch.autograd.Function`` and the masked
mean runs outside it, so autograd hands the backward each token's
coefficient, as ``jax.custom_vjp`` does. Each wrapper takes the plain
version for CPU tensors only; for a CUDA tensor it launches its kernel or
raises (fp32 included).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from deepspeed_tpu_torch.ops.kernels import build

_LOG2E = 1.4426950408889634
_MASKED = -1e30
_BM = 128                          # token tile of F and G (G's db partial rows)
_BN = 256                          # vocab tile of F and G (F's partials)

#: kernel launches since the last reset (set them to 0 to start counting)
fwd_launches = 0
ds_launches = 0
dh_launches = 0
dw_launches = 0

_DTYPE_CODE = {torch.float16: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------- #
# plain versions (the kernels' math in plain PyTorch, fp32)


def _log2_logits(h, w, bias):
    """``(h W + b) log2e`` ``[N, V]`` in fp32 from storage-dtype operands
    (the TPU kernels' ``_block_logits``)."""
    s = h.float() @ w.float()
    if bias is not None:
        s = s + bias.float()
    return s * _LOG2E


def fused_ce_fwd_plain(h, w, bias, labels):
    """F's math: per-token nll (natural log) and log2-domain lse ``[N]``
    fp32 for h ``[N, D]``, W ``[D, V]``, labels ``[N]`` in ``[0, V)``."""
    s = _log2_logits(h, w, bias)
    m = s.amax(dim=-1, keepdim=True)
    lse = (m + torch.log2(torch.exp2(s - m).sum(dim=-1, keepdim=True)))[:, 0]
    gold = torch.gather(s, 1, labels.long()[:, None])[:, 0]
    return (lse - gold) / _LOG2E, lse


def fused_ce_fwd_tiles_plain(h, w, bias, labels):
    """F's schedule in plain PyTorch: the ``[3, ceil(V / 256), N]`` fp32
    partials that the kernel writes, each 256-wide vocab tile's max, sum of
    ``exp2(s - max)`` and gold logit (0 where the label lies in another
    tile), from the same log2-domain logits."""
    s = _log2_logits(h, w, bias)
    N, V = s.shape
    nvt = -(-V // _BN)
    s = torch.nn.functional.pad(s, (0, nvt * _BN - V), value=_MASKED).reshape(N, nvt, _BN)
    m = s.amax(dim=-1)
    l = torch.exp2(s - m[..., None]).sum(dim=-1)
    rows, lab = torch.arange(N, device=s.device), labels.long()
    gold = torch.zeros_like(m)
    gold[rows, lab // _BN] = s[rows, lab // _BN, lab % _BN]
    return torch.stack([m.T, l.T, gold.T])


def fused_ce_combine_plain(part):
    """The combine kernel's math: a token's partials merged in tile order
    into ``(nll, lse)`` ``[N]`` fp32 (lse in the log2 domain)."""
    m, l, gold = part
    mx = m.amax(dim=0)
    lse = mx + torch.log2((l * torch.exp2(m - mx)).sum(dim=0))
    return (lse - gold.sum(dim=0)) / _LOG2E, lse


def fused_ce_ds_plain(h, w, bias, labels, lse, coef):
    """G's math: ``ds = (exp2(s - lse) - onehot) * coef`` in fp32, returned
    in h's dtype ``[N, V]`` (the TPU backward kernels' rounding point), and
    ``db = sum_t ds`` fp32 ``[V]`` (None without a bias)."""
    s = _log2_logits(h, w, bias)
    p = torch.exp2(s - lse.float()[:, None])
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
    ds = p * coef.float()[:, None]
    return ds.to(h.dtype), (ds.sum(dim=0) if bias is not None else None)


def fused_ce_dh_plain(ds, w):
    """``dh = ds W^T`` ``[N, D]``, fp32 accumulation, in ds's dtype."""
    return (ds.float() @ w.float().T).to(ds.dtype)


def fused_ce_dw_plain(h, ds):
    """``dW = h^T ds`` ``[D, V]``, fp32 accumulation, in h's dtype."""
    return (h.float().T @ ds.float()).to(h.dtype)


# --------------------------------------------------------------------- #
# CUDA wrappers

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


def _bind(symbol: str, argtypes):
    fn = getattr(build.load("fused_cross_entropy"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, name, dev, *args):
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _head_weight(w):
    """W ``[D, V]`` as the kernels read it: ``(tensor, stored_as_vd, ld)``,
    where ``stored_as_vd`` means the memory is ``[V, D]`` (a tied head,
    ``embed.T``), read in place."""
    D, V = w.shape
    if w.stride(1) == 1 and w.stride(0) >= V:
        return w, False, w.stride(0)
    if w.stride(0) == 1 and w.stride(1) >= D:
        return w, True, w.stride(1)
    w = w.contiguous()
    return w, False, V


def _check_inputs(h, w, bias, labels):
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_cross_entropy kernels take fp16/bf16, got {h.dtype}")
    if w.dtype != h.dtype:
        raise TypeError(f"W dtype {w.dtype} differs from h's {h.dtype}")
    N, D = h.shape
    if w.shape[0] != D or labels.shape != (N,):
        raise ValueError(f"h {tuple(h.shape)}, W {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)}")
    for name, x in (("W", w), ("labels", labels), ("bias", bias)):
        if x is not None and x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if h.stride(1) != 1:
        raise ValueError("h must have unit column stride")


def _bias(bias, V):
    if bias is None:
        return None
    b = bias.to(torch.float32).contiguous()
    if b.shape != (V,):
        raise ValueError(f"bias shape {tuple(b.shape)}, expected ({V},)")
    return b


def _ptr(x):
    return None if x is None else x.data_ptr()


# --------------------------------------------------------------------- #
# operands of the TMA + wgmma products (F, G, dh, dW), decided from shapes
# and strides alone so the CPU tests reach every decision


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand of an F / G / dh / dW product as the kernel reads it.

    ``rows`` is a row-major view of its memory (unit column stride, row
    stride ``ld``, a multiple of 8 elements, base 16-byte aligned), which
    TMA reads in 128-byte boxes. ``major`` says what runs along those rows:
    ``"K"`` (the reduction axis: A stored ``[M, K]``, B stored ``[N, K]``)
    or ``"MN"`` (A stored ``[K, M]``, B stored ``[K, N]``)."""

    rows: torch.Tensor
    major: str

    @property
    def ld(self) -> int:
        return self.rows.stride(0)


def _tma_rows(x):
    """The matrix ``x`` as TMA reads it, row by row.

    A view with unit column stride whose row stride is a multiple of 8
    elements and whose base is 16-byte aligned is returned as it is (read in
    place). Otherwise (an untied W with V = 50257, h with D % 8 != 0, a
    plain ``[N, V]`` ds with V odd, a column-strided view) it is copied once
    into a buffer of ``[rows, cols rounded up to 8]``: the copy reads
    ``2 rows cols`` bytes and writes ``2 rows cols_rounded_up`` (16-bit
    elements). The pad columns are never read: the TMA map's extent is
    ``cols``."""
    r, c = x.shape
    if x.stride(1) == 1 and x.stride(0) >= c and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    buf = torch.empty((r, -(-c // 8) * 8), dtype=x.dtype, device=x.device)
    buf[:, :c].copy_(x)
    return buf[:, :c]


def _operand(x, major):
    return Operand(_tma_rows(x), major)


def _weight_rows(w):
    """W ``[D, V]``'s memory as a row-major view and whether it is a tied
    head's ``[V, D]`` (``W = embed.T``)."""
    w, vd, _ = _head_weight(w)
    return (w.T if vd else w), vd


def ds_operands(h, w):
    """The logits product ``h W`` of F and G: A = h ``[N, D]``, K-major; B =
    W as it lies, ``[D, V]`` (MN-major) or a tied head's ``[V, D]``
    (K-major)."""
    rows, vd = _weight_rows(w)
    return _operand(h, "K"), _operand(rows, "K" if vd else "MN")


def dh_operands(ds, w):
    """dh's product ``ds W^T``: A = ds ``[N, V]``, K-major; B = W^T, whose
    memory is W's ``[D, V]`` (``[N, K]``: K-major) or a tied head's ``[V,
    D]`` (``[K, N]``: MN-major)."""
    rows, vd = _weight_rows(w)
    return _operand(ds, "K"), _operand(rows, "MN" if vd else "K")


def dw_operands(h, ds, w):
    """dW's product: ``(A, B, tied)``. Untied: ``h^T ds`` ``[D, V]``, A =
    h^T (h's ``[N, D]`` is ``[K, M]``) and B = ds (``[K, N]``), both
    MN-major. Tied (``[V, D]`` memory): the kernel writes ``dE = ds^T h``
    ``[V, D]``, A = ds^T and B = h, the same layouts."""
    _, vd = _weight_rows(w)
    a, b = (ds, h) if vd else (h, ds)
    return _operand(a, "MN"), _operand(b, "MN"), vd


def tma_ready(h, w):
    """``(h, w)`` as F, G, dh and dW read them in place: each copied once
    into padded rows where TMA cannot read its rows (:func:`_tma_rows`),
    the same tensors otherwise. W keeps its ``[D, V]`` shape (a tied head's
    copy is still the transpose of a ``[V, D]`` buffer)."""
    rows, vd = _weight_rows(w)
    rows = _tma_rows(rows)
    return _tma_rows(h), (rows.T if vd else rows)


def fused_ce_fwd_cuda(h, w, bias, labels):
    """Launch F (and the combine) on CUDA tensors. Returns ``(nll, lse)``
    ``[N]`` fp32. h or W is copied first when TMA cannot read its rows in
    place (:func:`_tma_rows`)."""
    global fwd_launches
    _check_inputs(h, w, bias, labels)
    N, D = h.shape
    V = w.shape[1]
    a, b_op = ds_operands(h, w)
    bias32 = _bias(bias, V)
    part = torch.empty((3, -(-V // _BN), N), dtype=torch.float32, device=h.device)
    nll = torch.empty((N,), dtype=torch.float32, device=h.device)
    lse = torch.empty_like(nll)
    fn = _bind("ds_fused_ce_fwd", [_P, _L, _P, _I, _L] + [_P] * 5 + [_I] * 4 + [_P])
    _launch(fn, "fused_ce_fwd", h.device, a.rows.data_ptr(), a.ld, b_op.rows.data_ptr(),
            int(b_op.major == "K"), b_op.ld, _ptr(bias32), labels.data_ptr(), part.data_ptr(),
            nll.data_ptr(), lse.data_ptr(), N, D, V, _DTYPE_CODE[h.dtype])
    fwd_launches += 1
    return nll, lse


def fused_ce_ds_cuda(h, w, bias, labels, lse, coef):
    """Launch G on CUDA tensors. Returns ``(ds, db)``: ds ``[N, V]`` in h's
    dtype (a view of an ``[N, V rounded up to 8]`` buffer), db ``[V]`` fp32
    or None without a bias. h or W is copied first when TMA cannot read its
    rows in place (:func:`_tma_rows`)."""
    global ds_launches
    _check_inputs(h, w, bias, labels)
    N, D = h.shape
    V = w.shape[1]
    for name, x in (("lse", lse), ("coef", coef)):
        if x.shape != (N,) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{N}]")
    a, b_op = ds_operands(h, w)
    bias32 = _bias(bias, V)
    ld = -(-V // 8) * 8
    ds = torch.empty((N, ld), dtype=h.dtype, device=h.device)
    db_part = db = None
    if bias32 is not None:
        db_part = torch.empty((-(-N // _BM), V), dtype=torch.float32, device=h.device)
        db = torch.empty((V,), dtype=torch.float32, device=h.device)
    fn = _bind("ds_fused_ce_ds", [_P, _L, _P, _I, _L] + [_P] * 5 + [_L, _P, _P] + [_I] * 4 + [_P])
    _launch(fn, "fused_ce_ds", h.device, a.rows.data_ptr(), a.ld, b_op.rows.data_ptr(),
            int(b_op.major == "K"), b_op.ld, _ptr(bias32), labels.data_ptr(), lse.data_ptr(),
            coef.data_ptr(), ds.data_ptr(), ld, _ptr(db_part), _ptr(db), N, D, V,
            _DTYPE_CODE[h.dtype])
    ds_launches += 1
    return ds[:, :V], db


def _check_pair(a, b, name):
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"{name} takes fp16/bf16 operands of one dtype, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name} operands on {a.device} and {b.device}")


def fused_ce_dh_cuda(ds, w):
    """Launch the dh product on CUDA tensors: ``ds [N, V] W^T`` -> ``[N, D]``
    (operands as :func:`dh_operands` says)."""
    global dh_launches
    _check_pair(ds, w, "fused_ce_dh")
    N, V = ds.shape
    D = w.shape[0]
    a, b = dh_operands(ds, w)
    dh = torch.empty((N, D), dtype=ds.dtype, device=ds.device)
    fn = _bind("ds_ce_dh_gemm", [_P, _L, _P, _L, _I, _P, _L] + [_I] * 4 + [_P])
    _launch(fn, "fused_ce_dh", ds.device, a.rows.data_ptr(), a.ld, b.rows.data_ptr(), b.ld,
            int(b.major == "K"), dh.data_ptr(), D, N, D, V, _DTYPE_CODE[ds.dtype])
    dh_launches += 1
    return dh


def fused_ce_dw_cuda(h, ds, w):
    """Launch the dW product on CUDA tensors: ``h^T ds`` ``[D, V]``, laid out
    like ``w``: for W stored ``[V, D]`` (tied) the kernel writes ``ds^T h``
    ``[V, D]`` and this returns its transpose (a view)."""
    global dw_launches
    _check_pair(h, ds, "fused_ce_dw")
    N, D = h.shape
    V = ds.shape[1]
    a, b, tied = dw_operands(h, ds, w)
    M, Ncols = (V, D) if tied else (D, V)
    out = torch.empty((M, Ncols), dtype=h.dtype, device=h.device)
    fn = _bind("ds_ce_dw_gemm", [_P, _L, _P, _L, _P, _L] + [_I] * 4 + [_P])
    _launch(fn, "fused_ce_dw", h.device, a.rows.data_ptr(), a.ld, b.rows.data_ptr(), b.ld,
            out.data_ptr(), Ncols, M, Ncols, N, _DTYPE_CODE[h.dtype])
    dw_launches += 1
    return out.T if tied else out


# --------------------------------------------------------------------- #
# dispatch: the kernel for CUDA tensors, the plain version for CPU tensors only


def _device_of(x, name):
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: no kernel for device {x.device}")


def fused_ce_fwd(h, w, bias, labels):
    """F: ``(nll, lse)`` ``[N]`` fp32 (lse in the log2 domain)."""
    if _device_of(h, "fused_ce_fwd") == "cuda":
        return fused_ce_fwd_cuda(h, w, bias, labels)
    return fused_ce_fwd_plain(h, w, bias, labels)


def fused_ce_ds(h, w, bias, labels, lse, coef):
    """G: ``(ds [N, V] in h's dtype, db [V] fp32 or None)``."""
    if _device_of(h, "fused_ce_ds") == "cuda":
        return fused_ce_ds_cuda(h, w, bias, labels, lse, coef)
    return fused_ce_ds_plain(h, w, bias, labels, lse, coef)


def fused_ce_dh(ds, w):
    """``dh = ds W^T``."""
    if _device_of(ds, "fused_ce_dh") == "cuda":
        return fused_ce_dh_cuda(ds, w)
    return fused_ce_dh_plain(ds, w)


def fused_ce_dw(h, ds, w):
    """``dW = h^T ds``, laid out like ``w``."""
    if _device_of(h, "fused_ce_dw") == "cuda":
        return fused_ce_dw_cuda(h, ds, w)
    return fused_ce_dw_plain(h, ds)


class _FusedCE(torch.autograd.Function):
    """Per-token nll of the vocab head: F forward; G, dh and dW backward
    (the TPU package's ``jax.custom_vjp`` around its three kernels). The
    incoming gradient is each token's coefficient from the masked mean."""

    @staticmethod
    def forward(ctx, h, w, bias, labels):
        if h.is_cuda:
            h, w = tma_ready(h, w)       # one copy of an unaligned operand, kept for the backward
        nll, lse = fused_ce_fwd(h, w, bias, labels)
        ctx.save_for_backward(h, w, bias, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, bias, labels, lse = ctx.saved_tensors
        ds, db = fused_ce_ds(h, w, bias, labels, lse, g.float().contiguous())
        dh = fused_ce_dh(ds, w) if ctx.needs_input_grad[0] else None
        dw = fused_ce_dw(h, ds, w) if ctx.needs_input_grad[1] else None
        return dh, dw, (db if ctx.needs_input_grad[2] else None), None


def fused_cross_entropy(h, w, labels, bias=None, valid=None):
    """Mean token cross-entropy of the vocab head ``h @ w + bias`` against
    ``labels``, the logits never formed (the counterpart of
    ``deepspeed_tpu.ops.pallas.fused_cross_entropy.fused_cross_entropy``).

    h ``[..., D]``; w ``[D, V]`` (a transposed ``[V, D]`` view is read in
    place); bias optional ``[V]``; labels ``[...]`` in ``[0, V)`` (mask
    ignore-index positions through ``valid`` and clamp them, as
    ``chunked_vocab_ce``'s safe labels); valid optional ``[...]`` keep-mask.
    Returns ``sum(nll * valid) / max(sum(valid), 1)``, differentiable in h,
    w and bias. W is cast to h's dtype outside the autograd Function, so
    autograd casts dW back to w's dtype."""
    D = h.shape[-1]
    if w.shape[0] != D:
        raise ValueError(f"w {tuple(w.shape)} does not match features D={D}")
    N = labels.numel()
    if h.numel() != N * D:
        raise ValueError(f"h {tuple(h.shape)} does not match labels {tuple(labels.shape)}")
    hp = h.reshape(N, D).contiguous()
    if w.dtype != hp.dtype:
        w = w.to(hp.dtype)
    b = None if bias is None else bias.to(torch.float32)
    nll = _FusedCE.apply(hp, w, b, labels.reshape(N).to(torch.int32))
    vf = (torch.ones((N,), dtype=torch.float32, device=h.device) if valid is None
          else valid.reshape(N).to(torch.float32))
    return torch.sum(nll * vf) / torch.clamp(torch.sum(vf), min=1.0)
