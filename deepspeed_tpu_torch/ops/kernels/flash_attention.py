"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` (kernel
A, forward) and ``csrc/flash_attention_bwd.cu`` (kernels C and D, the
backward's dq and dk/dv), and their plain PyTorch versions.

Replaces the TPU kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
``_fwd_kernel`` / ``_dq_kernel`` / ``_dkv_kernel`` (the general kernels, GQA
and Hd = 128) and their packed-heads twins ``_packed_*_kernel`` (MHA with
Hd < 128, e.g. GPT-2's 64). The Hopper kernels read ``[B, S, H, Hd]`` in
place for both, so one kernel covers each pair of call sites.

What bounds them on the H100, and what the designs do about it: at prefill
lengths the forward is memory-bound on the q/k/v/o bytes (it reaches the
bf16 ridge of about 295 FLOP/byte only near S = 1000 at Hd = 128); the
backward at training lengths does 3 (dq) and 4 (dk, dv) S x S x Hd products
and is compute-bound. All three run on TMA + wgmma (``csrc/wgmma_attention.cuh``):
A and C q-stationary, D k-stationary, each with a producer warp feeding a
ring of shared-memory stages and two consumer warpgroups. None of the
kernels writes an S x S tile: the forward keeps its running softmax in fp32
registers and writes the log2-domain lse, from which the backward
recomputes p. See the sources' headers for the layouts.

Head dims: the kernels are built for Hd 64, 128 and 256 (64-column TMA
boxes; GPT-J's 256-wide heads run A on 64-key k/v tiles, C on 32-key k/v
stages and D as its own 64-key kernel with one consumer warpgroup per
accumulator); any other multiple of 8 up to 256 is zero-padded here to the
next of them (q k^T and p v do not change with zero columns; the scale
stays the one of the true Hd) and the outputs are sliced back.

Block-sparse attention (``block_layout``, the TPU kernels' ``has_layout``
mode): an ``[H, nb, nb]`` (or ``[nb, nb]``) layout whose entries > 0 keep a
(query block, key block) pair of S / nb tokens each. :func:`live_tiles`
turns it, once per (layout, S, causal), into each kernel's live-tile lists:
per (head, 128-row q tile) the k tiles of A (128 keys) and of C (64 keys),
and per (kv head, 128-key tile) the (query head of the group, 64-row q
tile) pairs of D, each flagged full or partial. The producer and the
consumers of each kernel walk the same list, so a dead tile costs neither
bytes nor products; on a partial tile (one that straddles layout blocks,
which never happens at a block that is a multiple of 128) the layout masks
each element. A row with no live key gets o = 0 and lse = +1e30, and zero
gradients, as in the TPU kernels. ``tile_counts()`` reads the tiles each
kernel walked on the card since ``reset_tile_counts()``.

:func:`flash_attention` is differentiable: its forward is the op
``dstpu::flash_fwd`` (:func:`flash_fwd`), whose autograd saves
``(q, k, v, o, lse, mask, slopes)``, computes ``delta = sum(do * o)`` in fp32
with plain torch (as the JAX package does in XLA) and runs C and D. With
``return_lse=True`` the lse is differentiable too (the JAX package's
``flash_lse``, through which ring attention combines blocks): its cotangent
folds into the row term, ``delta' = delta - log2(e) * dlse``. Each
wrapper takes the plain version for CPU tensors only; for a CUDA tensor it
launches its kernel or raises. ``launches``, ``dq_launches`` and
``dkv_launches`` count kernel launches of A, C and D (a run's proof that it
went through them).
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import Optional, Tuple

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


def _log2_logits(q, k, mask_bias, causal: bool, alibi_slopes, scale: float, block_layout=None):
    """The kernels' log2-domain logits ``[B, KV, G, S, S]`` in fp32: scaled
    q k^T with ALiBi, -1e30 above the causal diagonal, plus the key-side
    mask bias (the TPU kernels' ``_block_bias``); -inf where ``block_layout``
    drops the pair, so that it adds nothing to a row's mass (the TPU kernels
    skip such blocks)."""
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
    if block_layout is not None:
        keep = _layout_keep(block_layout, S, H, causal).to(q.device)
        lb = S // keep.shape[-1]
        keep = keep.repeat_interleave(lb, 1).repeat_interleave(lb, 2).reshape(KV, G, S, S)
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _scale(q, scale):
    return float(scale if scale is not None else q.shape[-1]**-0.5)


def flash_attention_plain(q, k, v, mask_bias=None, causal: bool = True,
                          alibi_slopes=None, scale: Optional[float] = None, block_layout=None):
    """Kernel A's math in plain PyTorch, fp32 throughout: log2-domain
    logits with the same masking conventions (the running max starts at
    -1e30, so a row whose every logit is at or below it has no mass), p
    rounded to v's dtype before the P V product, and the log2-domain lse
    ``[B, H, S]`` (+1e30 for a row with no mass, and so for a row that the
    layout leaves no key). Returns ``(out [B, S, H, Hd] in q's dtype, lse)``."""
    B, S, H, Hd = q.shape
    s = _log2_logits(q, k, mask_bias, causal, alibi_slopes, _scale(q, scale), block_layout)
    m = s.amax(dim=-1, keepdim=True).clamp(min=_MASKED)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bcgqk,bkcd->bqcgd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = o / safe_l.permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m + torch.log2(safe_l), torch.full_like(l, -_MASKED))
    return o.reshape(B, S, H, Hd).to(q.dtype), lse.reshape(B, H, S)


def _p_and_ds_terms(q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, scale,
                    block_layout):
    """p = exp2(s - lse) ``[B, KV, G, Sq, Sk]`` and dp - delta, both fp32."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    s = _log2_logits(q, k, mask_bias, causal, alibi_slopes, scale, block_layout)
    p = torch.exp2(s - lse.float().reshape(B, KV, G, S, 1))
    do5 = do.float().reshape(B, S, KV, G, Hd)
    dp = torch.einsum("bqcgd,bkcd->bcgqk", do5, v.float())
    return p, dp - delta.float().reshape(B, KV, G, S, 1)


def flash_attention_dq_plain(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                             alibi_slopes=None, scale: Optional[float] = None,
                             block_layout=None):
    """Kernel C's math (the TPU ``_dq_kernel``) in plain PyTorch: p stays
    fp32, ``ds = p (dp - delta) scale`` is rounded to k's dtype, ``dq = ds
    k`` accumulates in fp32 and comes back in q's dtype ``[B, S, H, Hd]``.
    ``lse`` / ``delta`` are ``[B, H, S]`` fp32 (lse log2-domain, from the
    forward; delta = sum(do * o) over Hd)."""
    B, S, H, Hd = q.shape
    sc = _scale(q, scale)
    p, dpd = _p_and_ds_terms(q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, sc,
                             block_layout)
    ds = (p * dpd * sc).to(k.dtype).float()
    dq = torch.einsum("bcgqk,bkcd->bqcgd", ds, k.float())
    return dq.reshape(B, S, H, Hd).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                              alibi_slopes=None, scale: Optional[float] = None,
                              block_layout=None):
    """Kernel D's math (the TPU ``_dkv_kernel``) in plain PyTorch: p is
    rounded to do's dtype and that p feeds both ``dv = p^T do`` and ``ds =
    p (dp - delta) scale``, which is rounded to q's dtype for ``dk = ds^T
    q``; both sum over the G query heads of each kv group in fp32 and come
    back in q's dtype ``[B, S, KV, Hd]``."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    sc = _scale(q, scale)
    p, dpd = _p_and_ds_terms(q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, sc,
                             block_layout)
    p = p.to(do.dtype).float()
    ds = (p * dpd * sc).to(q.dtype).float()
    dv = torch.einsum("bcgqk,bqcgd->bkcd", p, do.float().reshape(B, S, KV, G, Hd))
    dk = torch.einsum("bcgqk,bqcgd->bkcd", ds, q.float().reshape(B, S, KV, G, Hd))
    return dk.to(q.dtype), dv.to(q.dtype)


# --------------------------------------------------------------------- #
# block layouts and the kernels' live-tile lists

def _layout_keep(block_layout, S: int, H: int, causal: bool) -> torch.Tensor:
    """The layout as a bool ``[H, nb, nb]`` CPU tensor (entries > 0 keep; a
    2-D layout broadcast over the heads), with the blocks above the causal
    diagonal dropped (the TPU kernels skip them); the JAX package's checks."""
    layout = torch.as_tensor(block_layout).detach().cpu()
    if layout.ndim == 2:
        layout = layout[None].expand(H, *layout.shape)
    nb = layout.shape[-1]
    if layout.ndim != 3 or layout.shape[0] != H or layout.shape[1] != nb:
        raise ValueError(f"block_layout shape {tuple(torch.as_tensor(block_layout).shape)}; "
                         f"expected [{H}, nb, nb] or [nb, nb]")
    if S % nb != 0:
        raise ValueError(f"seq len {S} not divisible by layout blocks {nb}")
    lb = S // nb
    if lb < 8 or lb % 8 != 0:
        raise ValueError(
            f"layout block size {lb} (= S/{nb}) must be a multiple of 8 for the "
            "kernels' tiling; use a coarser SparsityConfig block")
    keep = layout > 0
    if causal:
        keep = keep & torch.ones((nb, nb), dtype=torch.bool).tril()
    return keep


# the kernels' tiles: A 128 q x 128 k, C 128 q x 64 k, D 128 k x 64 q
_TILES = {"fwd": (128, 128), "dq": (128, 64), "dkv": (64, 128)}


def _tile_grid(keep, S: int, tq: int, tk: int, causal: bool):
    """``(live, full)`` bool ``[H, ceil(S / tq), ceil(S / tk)]``: a tile is
    live when it holds a kept (query, key) pair below the causal diagonal,
    full when every pair of it inside S is kept (so it needs no element mask)."""
    H, nb, _ = keep.shape
    lb = S // nb
    a = math.gcd(lb, 64)                      # atoms: every tile and block is whole atoms
    atoms = keep.repeat_interleave(lb // a, 1).repeat_interleave(lb // a, 2)
    n, nq, nk = S // a, -(-S // tq), -(-S // tk)

    def tiles(fill, reduce):
        grid = torch.full((H, nq * tq // a, nk * tk // a), fill, dtype=torch.bool)
        grid[:, :n, :n] = atoms
        return reduce(grid.view(H, nq, tq // a, nk, tk // a), (2, 4))

    live = tiles(False, torch.any)
    full = tiles(True, torch.all)
    if causal:        # a tile wholly above the diagonal holds no pair of the causal mask
        q_last = torch.clamp(torch.arange(nq) * tq + tq, max=S) - 1
        live &= (torch.arange(nk) * tk)[None, :] <= q_last[:, None]
    return live, full


def _csr(live, full, code):
    """``(offsets, entries)`` int32 of one list per row of ``live`` ``[R,
    M]``: entries ``code << 1 | partial`` of the live candidates, in order."""
    offsets = torch.zeros(live.shape[0] + 1, dtype=torch.int32)
    offsets[1:] = live.sum(-1).cumsum(0)
    entries = (code.expand_as(live) * 2 + (~full).int())[live]
    return offsets, entries.to(torch.int32)


def live_tiles(keep, S: int, causal: bool, kernel: str, kv_heads: int):
    """The live-tile lists of kernel ``kernel`` ("fwd" A, "dq" C, "dkv" D)
    for the kept blocks ``keep`` ``[H, nb, nb]``: ``(offsets, entries)``,
    CPU int32. A and C: one list per (head, 128-row q tile), the k tile
    indices in ascending order. D: one list per (kv head, 128-key tile),
    the (query head of the group g, 64-row q tile t) pairs coded g * nq +
    t, g-major as D's dense loop walks them. Each entry is ``index << 1 |
    partial``."""
    tq, tk = _TILES[kernel]
    live, full = _tile_grid(keep, S, tq, tk, causal)
    H, nq, nk = live.shape
    if kernel != "dkv":
        return _csr(live.reshape(H * nq, nk), full.reshape(H * nq, nk), torch.arange(nk))
    G = H // kv_heads
    by_key = lambda x: x.reshape(kv_heads, G, nq, nk).permute(0, 3, 1, 2).reshape(
        kv_heads * nk, G * nq)
    return _csr(by_key(live), by_key(full), torch.arange(G * nq))


class _Layout:
    """One layout's device-side pieces for the kernels: the kept blocks as
    uint8 ``[H, nb, nb]`` (for the partial tiles' element mask) and each
    kernel's live-tile lists, made on first use."""

    def __init__(self, keep, S, causal, device):
        self.keep, self.S, self.causal, self.device = keep, S, causal, device
        self.nb = keep.shape[-1]
        self.blocks = keep.to(torch.uint8).contiguous().to(device)
        self._lists = {}

    def lists(self, kernel: str, kv_heads: int):
        key = (kernel, kv_heads if kernel == "dkv" else 0)
        if key not in self._lists:
            self._lists[key] = tuple(x.to(self.device) for x in
                                     live_tiles(self.keep, self.S, self.causal, kernel, kv_heads))
        return self._lists[key]


_LAYOUTS: "OrderedDict[tuple, _Layout]" = OrderedDict()
# the last layout object seen at each (S, H, causal, device): the model passes
# the same layout tensor to every layer, so its pieces are found without
# reading its content again (the object is held, so its id is not reused)
_LAST: dict = {}


def _device_layout(block_layout, S, H, causal, device) -> _Layout:
    """The cached :class:`_Layout` of a layout's content at (S, causal, device)."""
    where = (S, H, bool(causal), str(device))
    last = _LAST.get(where)
    version = getattr(block_layout, "_version", None)
    if last is not None and last[0] is block_layout and version is not None \
            and last[1] == version:
        return last[2]
    keep = _layout_keep(block_layout, S, H, causal)
    key = (keep.numpy().tobytes(), tuple(keep.shape)) + where
    hit = _LAYOUTS.get(key)
    if hit is None:
        hit = _LAYOUTS[key] = _Layout(keep, S, causal, device)
        if len(_LAYOUTS) > 64:
            _LAYOUTS.popitem(last=False)
    _LAYOUTS.move_to_end(key)
    _LAST[where] = (block_layout, version, hit)
    return hit


#: tiles walked on the card by A, C and D with a layout, one device counter
#: each (a kernel's producer adds its CTA's list length)
_walked = {}


def _walked_counter(device):
    if device not in _walked:
        _walked[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return _walked[device]


def reset_tile_counts():
    """Set the tile counters of every device to 0."""
    for c in _walked.values():
        c.zero_()


def tile_counts():
    """``{"fwd": n, "dq": n, "dkv": n}``: the tiles A, C and D walked over
    their live-tile lists since :func:`reset_tile_counts`, summed over the
    devices (reading them synchronises)."""
    total = [0, 0, 0]
    for c in _walked.values():
        total = [t + int(x) for t, x in zip(total, c.tolist())]
    return dict(zip(("fwd", "dq", "dkv"), total))


# --------------------------------------------------------------------- #
# the kernels

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


#: the largest head dim of the forward kernel A, and of the backward kernels C and D
FWD_MAX_HEAD_DIM = 256
BWD_MAX_HEAD_DIM = 256


def kernel_head_dim(Hd: int, most: int = FWD_MAX_HEAD_DIM) -> int:
    """The head dim the kernels run a head of ``Hd`` at: 64, 128 or 256,
    the columns past Hd zero; ``most`` is the largest the kernel takes."""
    if Hd % 8 or not 8 <= Hd <= most:
        raise ValueError(f"flash_attention kernels take a head_dim that is a multiple of 8 "
                         f"up to {most}, got {Hd}")
    return 64 if Hd <= 64 else 128 if Hd <= 128 else 256


def pad_head_dim(x, hd: int):
    """``x`` ``[..., Hd]`` with zero columns up to ``hd`` (itself when Hd = hd)."""
    return x if x.shape[-1] == hd else torch.nn.functional.pad(x, (0, hd - x.shape[-1]))


def _kernel_inputs(q, k, v, mask_bias, alibi_slopes):
    """Check what every kernel of this module takes; returns the fp32 mask
    and slopes (or None) on q's device."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernels take fp16/bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if Hd not in (64, 128, 256):
        raise ValueError(f"the kernels run head_dim 64, 128 or 256 (pad_head_dim), got {Hd}")
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


def _tile_args(q, block_layout, causal, kernel, kv_heads):
    """The kernels' five layout arguments: list offsets, list entries, the
    kept blocks, nb and the walked-tile counter (all null / 0 without a
    layout)."""
    if block_layout is None:
        return [None, None, None, 0, None]
    S, H = q.shape[1], q.shape[2]
    lay = _device_layout(block_layout, S, H, causal, q.device)
    offsets, entries = lay.lists(kernel, kv_heads)
    walked = _walked_counter(q.device)[("fwd", "dq", "dkv").index(kernel):]
    return [offsets.data_ptr(), entries.data_ptr(), lay.blocks.data_ptr(), lay.nb,
            walked.data_ptr()]


_TILE_ARGTYPES = [_P, _P, _P, _I, _P]


def _launch(fn, name, q, *args):
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def flash_attention_cuda(q, k, v, mask_bias=None, causal: bool = True,
                         alibi_slopes=None, scale: Optional[float] = None, block_layout=None):
    """Launch kernel A on CUDA tensors. Returns ``(out, lse)``."""
    global launches
    B, S, H, Hd = q.shape
    sc = _scale(q, scale)
    hd = kernel_head_dim(Hd)
    q, k, v = (pad_head_dim(x, hd) for x in (q, k, v))
    mask, slopes = _kernel_inputs(q, k, v, mask_bias, alibi_slopes)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    tiles = _tile_args(q, block_layout, causal, "fwd", k.shape[2])
    fn = _bind("flash_attention", "ds_flash_attention_fwd",
               [_P] * 7 + [_I] * 6 + [_F, _I] + _TILE_ARGTYPES + [_P])
    _launch(fn, "flash_attention_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _ptr(mask), _ptr(slopes), B, S, H, k.shape[2], hd,
            int(bool(causal)), sc * _LOG2E, _DTYPE_CODE[q.dtype], *tiles)
    launches += 1
    return (o if hd == Hd else o[..., :Hd].contiguous()), lse


def _bwd_inputs(q, k, v, do, lse, delta, mask_bias, alibi_slopes):
    mask, slopes = _kernel_inputs(q, k, v, mask_bias, alibi_slopes)
    B, S, H, _ = q.shape
    _check("do", do, q, q.shape, q.dtype)
    _check("lse", lse, q, (B, H, S), torch.float32)
    _check("delta", delta, q, (B, H, S), torch.float32)
    return mask, slopes


def flash_attention_dq_cuda(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                            alibi_slopes=None, scale: Optional[float] = None,
                            block_layout=None):
    """Launch kernel C on CUDA tensors. Returns dq ``[B, S, H, Hd]``."""
    global dq_launches
    B, S, H, Hd = q.shape
    sc = _scale(q, scale)
    hd = kernel_head_dim(Hd, BWD_MAX_HEAD_DIM)
    q, k, v, do = (pad_head_dim(x, hd) for x in (q, k, v, do))
    mask, slopes = _bwd_inputs(q, k, v, do, lse, delta, mask_bias, alibi_slopes)
    dq = torch.empty_like(q)
    tiles = _tile_args(q, block_layout, causal, "dq", k.shape[2])
    fn = _bind("flash_attention_bwd", "ds_flash_attention_bwd_dq",
               [_P] * 9 + [_I] * 6 + [_F, _F, _I] + _TILE_ARGTYPES + [_P])
    _launch(fn, "flash_attention_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(slopes),
            dq.data_ptr(), B, S, H, k.shape[2], hd, int(bool(causal)), sc * _LOG2E, sc,
            _DTYPE_CODE[q.dtype], *tiles)
    dq_launches += 1
    return dq if hd == Hd else dq[..., :Hd].contiguous()


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                             alibi_slopes=None, scale: Optional[float] = None,
                             block_layout=None):
    """Launch kernel D on CUDA tensors. Returns ``(dk, dv)`` ``[B, S, KV, Hd]``."""
    global dkv_launches
    B, S, H, Hd = q.shape
    sc = _scale(q, scale)
    hd = kernel_head_dim(Hd, BWD_MAX_HEAD_DIM)
    q, k, v, do = (pad_head_dim(x, hd) for x in (q, k, v, do))
    mask, slopes = _bwd_inputs(q, k, v, do, lse, delta, mask_bias, alibi_slopes)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    tiles = _tile_args(q, block_layout, causal, "dkv", k.shape[2])
    fn = _bind("flash_attention_bwd", "ds_flash_attention_bwd_dkv",
               [_P] * 10 + [_I] * 6 + [_F, _F, _I] + _TILE_ARGTYPES + [_P])
    _launch(fn, "flash_attention_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(slopes),
            dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], hd, int(bool(causal)),
            sc * _LOG2E, sc, _DTYPE_CODE[q.dtype], *tiles)
    dkv_launches += 1
    if hd != Hd:
        dk, dv = dk[..., :Hd].contiguous(), dv[..., :Hd].contiguous()
    return dk, dv


def _dispatch(cuda_fn, plain_fn, name, q, *args):
    """The kernel for CUDA tensors, the plain version for CPU tensors only."""
    if q.is_cuda:
        return cuda_fn(q, *args)
    if q.device.type == "cpu":
        return plain_fn(q, *args)
    raise ValueError(f"{name}: no kernel for device {q.device}")


def flash_attention_dq(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                       alibi_slopes=None, scale: Optional[float] = None, block_layout=None):
    """dq of flash attention from the forward's lse and ``delta = sum(do *
    o)``: kernel C on the card, :func:`flash_attention_dq_plain` on the CPU."""
    return _dispatch(flash_attention_dq_cuda, flash_attention_dq_plain, "flash_attention_dq",
                     q, k, v, do, lse, delta, mask_bias, causal, alibi_slopes, scale,
                     block_layout)


def flash_attention_dkv(q, k, v, do, lse, delta, mask_bias=None, causal: bool = True,
                        alibi_slopes=None, scale: Optional[float] = None, block_layout=None):
    """(dk, dv) of flash attention, summed over each kv group: kernel D on
    the card, :func:`flash_attention_dkv_plain` on the CPU."""
    return _dispatch(flash_attention_dkv_cuda, flash_attention_dkv_plain,
                     "flash_attention_dkv", q, k, v, do, lse, delta, mask_bias, causal,
                     alibi_slopes, scale, block_layout)


def _forward(q, k, v, mask_bias, causal, alibi_slopes, scale, block_layout):
    return _dispatch(flash_attention_cuda, flash_attention_plain, "flash_attention",
                     q, k, v, mask_bias, causal, alibi_slopes, scale, block_layout)


@torch.library.custom_op("dstpu::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask_bias: Optional[torch.Tensor], alibi_slopes: Optional[torch.Tensor],
              block_layout: Optional[torch.Tensor], causal: bool,
              scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A's ``(o, lse)`` as one dispatcher op (the TPU package's
    ``flash`` / ``flash_lse`` ``jax.custom_vjp``, whose outputs carry the
    ``flash_o`` / ``flash_lse`` checkpoint names): kernel A for CUDA
    tensors, :func:`flash_attention_plain` for CPU tensors. An op, not a
    Python ``autograd.Function``, so that a selective checkpoint policy
    (``runtime/activation_checkpointing``) sees it, saves its outputs and
    skips it in the recompute. Its backward runs kernels C and D."""
    return _forward(q, k, v, mask_bias, causal, alibi_slopes, scale, block_layout)


@flash_fwd.register_fake
def _(q, k, v, mask_bias, alibi_slopes, block_layout, causal, scale):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, mask_bias, alibi_slopes, block_layout, causal, scale = inputs
    ctx.set_materialize_grads(False)     # an unused output's cotangent stays None
    ctx.save_for_backward(q, k, v, *output, mask_bias, alibi_slopes)
    ctx.causal, ctx.scale, ctx.block_layout = causal, scale, block_layout


def _flash_backward(ctx, do, dlse):
    """Kernels C and D. The forward reads nothing but its inputs, so a
    rematerialising checkpoint recomputes exactly the saved o and lse. The
    block layout rides along for the backward as it is (its live-tile
    lists are cached by content).

    The lse is the log2-domain ``log2(sum_k exp2(s2_k))`` with s2 =
    log2(e) * s, so d lse / d s_k = log2(e) p_k: an lse cotangent adds
    log2(e) * dlse * p_k to ds_k = p_k (dp_k - delta), and C and D take
    ``delta - log2(e) * dlse`` as their row term with no other change
    (``bwd_impl(res, g, glse)`` of the JAX package). A row with no mass
    (lse = +1e30) has p = 0 and drops its lse cotangent there too."""
    q, k, v, o, lse, mask_bias, slopes = ctx.saved_tensors
    do = torch.zeros_like(o) if do is None else do.contiguous()
    # delta in fp32 with plain torch, as the JAX package does in XLA
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - _LOG2E * dlse.float()
    args = (q, k, v, do, lse, delta.contiguous(), mask_bias, ctx.causal, slopes,
            ctx.scale, ctx.block_layout)
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkv(*args)
    return dq, dk, dv, None, None, None, None, None


flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q, k, v, mask_bias=None, causal: bool = True, alibi_slopes=None,
                    scale: Optional[float] = None, block_layout=None,
                    return_lse: bool = False):
    """Flash attention on ``[B, S, H, Hd]`` q and ``[B, S, KV, Hd]`` k/v
    (query head h reads kv head ``h // (H // KV)``); ``mask_bias`` is an
    additive key-side ``[B, S]`` bias, ``alibi_slopes`` ``[H]``. The
    counterpart of ``deepspeed_tpu.ops.pallas.flash_attention`` (the
    kernels' tiles are fixed, so there are no block-size knobs), and
    differentiable in q, k and v through kernels C and D.

    ``block_layout``: an ``[H, nb, nb]`` or ``[nb, nb]`` block-sparsity
    layout (:mod:`deepspeed_tpu_torch.ops.sparse_attention`), indexed by
    the query head; entries > 0 keep a block of S / nb tokens (a multiple of
    8). Dead blocks are skipped in the forward and the backward; causal,
    ``mask_bias`` and ALiBi compose with it.

    ``return_lse=True`` returns ``(out, lse)`` with lse the log2-domain
    logsumexp ``[B, H, S]`` (+1e30 for a row with no mass); both are
    differentiable, the lse's cotangent running through C and D."""
    H = q.shape[2]
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if block_layout is not None:
            block_layout = torch.as_tensor(block_layout)
        o, lse = flash_fwd(q, k, v, mask_bias, alibi_slopes, block_layout, causal, scale)
    else:
        o, lse = _forward(q, k, v, mask_bias, causal, alibi_slopes, scale, block_layout)
    return (o, lse) if return_lse else o
