"""Random layerwise token dropping, random-LTD (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_routing/basic_layer.py``; the
reference's ``basic_layer.py`` with the token sort, gather / scatter and
mask-slicing kernels of ``csrc/random_ltd/``).

The JAX package samples with ``jax.random.permutation`` and moves tokens
with ``jnp.take`` / ``.at[].set``, none of them a Pallas kernel; here they
are ``torch.randperm`` on an explicit generator, ``index_select`` /
``gather`` and ``index_copy`` / ``scatter``. The wrapper drops tokens before
a layer and scatters the layer's outputs back into the full sequence (the
skipped tokens ride the residual stream unchanged).

Indices are ``[keep]`` (one sorted set for the whole batch, as
:func:`token_sample` and ``gpt_sample_tokens`` give) or ``[B, keep]`` (one
set a row, as ``bert_sample_tokens`` gives, the layout of the reference's
``gather_scatter.cu``). The JAX functions take the first form; ``jnp.take``
would broadcast the second instead of gathering row by row.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def token_sample(generator: Optional[torch.Generator], seq_len: int, keep: int,
                 device=None) -> torch.Tensor:
    """Sorted random subset of ``keep`` token indices of ``range(seq_len)``
    (reference ``token_sort.cu``: kept tokens stay in order), drawn from
    ``generator`` on its device (``device`` without one)."""
    if generator is not None:
        device = generator.device
    perm = torch.randperm(seq_len, generator=generator, device=device)
    return torch.sort(perm[:keep]).values


def _row_index(indices, x):
    """``[B, keep]`` indices expanded over x's trailing dims, for gather / scatter."""
    idx = indices.long().reshape(indices.shape + (1,) * (x.dim() - 2))
    return idx.expand(indices.shape + x.shape[2:])


def gather_tokens(x, indices):
    """x ``[B, S, ...]`` -> ``[B, keep, ...]`` (reference ``gather_scatter.cu``)."""
    indices = torch.as_tensor(indices, device=x.device)
    if indices.dim() == 1:
        return x.index_select(1, indices.long())
    return torch.gather(x, 1, _row_index(indices, x))


def scatter_tokens(full, part, indices):
    """``part`` ``[B, keep, ...]`` written over ``full`` ``[B, S, ...]`` at
    ``indices`` (a new tensor; ``full`` is left as it is)."""
    indices = torch.as_tensor(indices, device=full.device)
    part = part.to(full.dtype)
    if indices.dim() == 1:
        return full.index_copy(1, indices.long(), part)
    return full.scatter(1, _row_index(indices, full), part)


def slice_attention_mask(mask_bias, indices):
    """Key-side additive mask ``[B, S]`` -> ``[B, keep]`` (reference
    ``slice_attn_masks.cu``)."""
    if mask_bias is None:
        return None
    return gather_tokens(mask_bias, indices)


class RandomLayerTokenDrop:
    """Wrap a transformer layer so it runs on a random token subset.

    ``layer_fn(x_subset, mask_subset, *args) -> y_subset``; dropped tokens
    ride the residual stream untouched. ``indices`` (keyword) gives the
    subset instead of sampling one from ``rng`` (``bert_sample_tokens``'s
    per-row sets).
    """

    def __init__(self, layer_fn: Callable):
        self.layer_fn = layer_fn

    def __call__(self, x, rng, keep: int, mask_bias=None, *args, indices=None):
        B, S = x.shape[:2]
        if indices is None:
            if keep >= S:
                return self.layer_fn(x, mask_bias, *args)
            indices = token_sample(rng, S, keep, device=x.device)
        sub = gather_tokens(x, indices)
        sub_mask = slice_attention_mask(mask_bias, indices)
        out = self.layer_fn(sub, sub_mask, *args)
        return scatter_tokens(x, out, indices)
