"""Random-LTD op surface (counterpart of
``deepspeed_tpu/ops/random_ltd/dropping_utils.py``; reference
``deepspeed/ops/random_ltd/dropping_utils.py`` over
``csrc/random_ltd/{token_sort,gather_scatter,slice_attn_masks}.cu``).

The reference's CUDA kernels have no Pallas counterpart in the JAX package
(``jax.random.permutation`` and ``jnp.take``), so the port runs the same
ops in plain torch (:mod:`~deepspeed_tpu_torch.runtime.data_pipeline.data_routing.basic_layer`),
sampling from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.basic_layer import (
    gather_tokens, scatter_tokens, slice_attention_mask, token_sample)

__all__ = ["gpt_sample_tokens", "bert_sample_tokens", "gather_tokens",
           "scatter_tokens", "slice_attention_mask", "token_sample"]


def _subsets(rng: Optional[torch.Generator], lead, seq_length: int, keep: int, device):
    """Sorted random ``keep``-subsets of ``range(seq_length)``, one per
    entry of ``lead``, in one draw: the ranks of uniform noise (a uniform
    random permutation a row), on ``rng``'s device (a fixed seed on
    ``device`` without one)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(0) if rng is None else rng
    noise = torch.rand(tuple(lead) + (seq_length,), generator=gen, device=gen.device)
    return torch.sort(noise.argsort(dim=-1)[..., :keep], dim=-1).values


def gpt_sample_tokens(reserved_length: int, seq_length: int, batch_size: int,
                      layers: int = 1, rng: Optional[torch.Generator] = None,
                      attn_mask=None, device=None):
    """Per-layer sorted token subsets for causal models (reference
    ``dropping_utils.py:16``): one index set per layer, shared across the
    batch; the mask ``[B, S]`` is sliced to the kept tokens. Draws from
    ``rng`` (a fixed seed without one).

    Returns ``(indices [layers, reserved], sliced_mask [layers, B, reserved] or None)``.
    """
    idx = _subsets(rng, (layers,), seq_length, reserved_length, device)
    mask = None
    if attn_mask is not None:
        mask = torch.stack([slice_attention_mask(attn_mask, idx[l]) for l in range(layers)])
    return idx, mask


def bert_sample_tokens(reserved_length: int, seq_length: int, batch_size: int,
                       layers: int = 1, rng: Optional[torch.Generator] = None,
                       attn_mask=None, device=None):
    """Per-(layer, row) sorted subsets for bidirectional models (reference
    ``dropping_utils.py:50``: each sequence samples independently).

    Returns ``(indices [layers, batch, reserved], sliced_mask [layers, batch, reserved] or None)``.
    """
    idx = _subsets(rng, (layers, batch_size), seq_length, reserved_length, device)
    mask = None
    if attn_mask is not None:
        mask = torch.stack([slice_attention_mask(attn_mask, idx[l]) for l in range(layers)])
    return idx, mask
