"""Compression primitives on tensors, the counterpart of
``deepspeed_tpu/compression/functional.py``:

- QAT fake quantization (symmetric / asymmetric, per tensor or grouped)
  with a straight-through-estimator gradient (a ``torch.autograd.Function``
  whose backward is the identity)
- magnitude pruning masks: unstructured (sparse), row, channel (column)
  and attention-head granularity

The arithmetic is the JAX package's, operation for operation: the
quantizer runs in fp32 with ``torch.round`` (half to even, as
``jnp.round``) and returns the input's dtype; each mask's threshold is the
k-th largest value, ``sort(x)[-k]`` along the last axis as ``jnp.sort``
takes it, and ties are kept by ``>=``. The masks are computed without
autograd: the gradient of ``w * mask`` is ``mask * g``, as in the JAX
package, where the comparison has no gradient. On the card these are
elementwise passes, sorts and reductions in plain torch, as XLA runs them
in the JAX package (there is no Pallas site here).
"""

from __future__ import annotations

from typing import Optional

import torch


# ------------------------------------------------------------------ #
# fake quantization (QAT) with straight-through estimator

def _scalar(x, value):
    """``value`` as a 0-dim fp32 tensor on x's device: dividing by it is a
    correctly rounded division on the card too (a Python number divisor
    becomes a multiplication by its reciprocal there)."""
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _quant_dequant(w, bits: int, symmetric: bool, groups: int):
    """Quantize -> dequantize in fp32 (the non-differentiable core)."""
    orig_shape = w.shape
    flat = w.float().reshape(groups, -1)
    qmax = 2.0 ** (bits - 1) - 1  # symmetric range
    if symmetric:
        scale = flat.abs().amax(dim=1, keepdim=True) / _scalar(flat, qmax)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(flat / scale), -qmax - 1, qmax)
        out = q * scale
    else:
        lo = flat.amin(dim=1, keepdim=True)
        hi = flat.amax(dim=1, keepdim=True)
        levels = 2.0**bits - 1
        scale = torch.where(hi > lo, (hi - lo) / _scalar(flat, levels), torch.ones_like(hi))
        q = torch.clamp(torch.round((flat - lo) / scale), 0, levels)
        out = q * scale + lo
    return out.reshape(orig_shape)


class _FakeQuantize(torch.autograd.Function):
    """Forward: the quantize / dequantize round trip in w's dtype; backward:
    the straight-through estimator (the cotangent passes unchanged)."""

    @staticmethod
    def forward(ctx, w, bits, symmetric, groups):
        return _quant_dequant(w, bits, symmetric, groups).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quantize(w, bits: int = 8, symmetric: bool = True, groups: int = 1):
    return _FakeQuantize.apply(w, int(bits), bool(symmetric), int(groups))


def quantize_activation(x, bits: int = 8, symmetric: bool = True):
    """Dynamic-range activation fake-quant (per tensor)."""
    return fake_quantize(x, bits, symmetric, 1)


# ------------------------------------------------------------------ #
# pruning masks (all return same-shape 0/1 masks; "l1" = magnitude)

def _kth_largest(x, k: int):
    """``jnp.sort(x)[-k]``: sorted along the last axis, row ``-k`` of the
    leading axis. For a vector that is the k-th largest element: on the
    card a radix sort reaches it fastest (``kthvalue`` selects within one
    thread block, 0.1 s for a 50 M stack), on the CPU a selection
    (``kthvalue``); the element is the same. For a 2-D ``x`` it is the row
    ``-k`` sorted, and JAX clamps an index past the leading axis to it, so
    a ``k`` beyond the rows reads row 0."""
    n = x.shape[0]
    if x.dim() == 1:
        if x.is_cuda:
            return torch.sort(x).values[n - k]
        return torch.kthvalue(x, n - k + 1).values
    return torch.sort(x[max(0, n - k)], dim=-1).values


@torch.no_grad()
def sparse_mask(w, dense_ratio: float) -> torch.Tensor:
    """Unstructured magnitude mask keeping the top ``dense_ratio`` fraction."""
    a = w.detach().abs()
    flat = a.reshape(-1)
    k = max(1, int(flat.numel() * dense_ratio))
    threshold = _kth_largest(flat, k)
    return (a >= threshold).to(w.dtype)


@torch.no_grad()
def row_mask(w, dense_ratio: float) -> torch.Tensor:
    """Keep the top rows (output neurons) by L1 norm; w [in, out] -> mask
    over dim 1 broadcast to w's shape. The norms sum over axis 0 and the
    threshold is ``jnp.sort(norms)[-k]`` as the JAX package writes them, so
    a stacked ``[L, in, out]`` leaf is summed over its layer axis."""
    norms = w.detach().abs().sum(dim=0)
    k = max(1, int(norms.numel() * dense_ratio))
    threshold = _kth_largest(norms, k)
    keep = (norms >= threshold).to(w.dtype)
    return torch.broadcast_to(keep[None], w.shape)


@torch.no_grad()
def channel_mask(w, dense_ratio: float) -> torch.Tensor:
    """Keep the top input channels by L1 norm; mask over dim 0."""
    norms = w.detach().abs().sum(dim=tuple(range(1, w.dim())))
    k = max(1, int(norms.numel() * dense_ratio))
    threshold = _kth_largest(norms, k)
    keep = (norms >= threshold).to(w.dtype)
    return torch.broadcast_to(keep.reshape((-1,) + (1,) * (w.dim() - 1)), w.shape)


@torch.no_grad()
def head_mask(w, num_heads: int, dense_ratio: float) -> torch.Tensor:
    """Keep the top attention heads by L1 norm of their output-projection
    slices; w [H*Hd, D] (attention output weight) -> per-head mask. The
    head width is read from ``w.shape[0]`` as in the JAX package, so a
    stacked ``[L, H*Hd, D]`` leaf raises where it raises there."""
    in_dim = w.shape[0]
    head_dim = in_dim // num_heads
    rest = w.numel() // (num_heads * head_dim)       # reshape(H, Hd, -1)'s -1
    per_head = w.detach().abs().reshape(num_heads, head_dim, rest).sum(dim=(1, 2))
    k = max(1, int(num_heads * dense_ratio))
    threshold = _kth_largest(per_head, k)
    keep = (per_head >= threshold).to(w.dtype)
    return torch.broadcast_to(keep[:, None, None],
                              (num_heads, head_dim, w.shape[1])).reshape(w.shape)


_MASK_FNS = {"sparse": sparse_mask, "row": row_mask, "channel": channel_mask}


def prune(w, method: str, dense_ratio: float, num_heads: Optional[int] = None):
    """Apply a pruning mask (recomputed each call during training, then
    frozen by redundancy_clean)."""
    if method == "head":
        return w * head_mask(w, num_heads, dense_ratio)
    return w * _MASK_FNS[method](w, dense_ratio)
