"""Checkpoint reshaping helpers (the port's copy of
``deepspeed_tpu/checkpoint/reshape_utils.py``): merge per-rank TP shards of
an external checkpoint into full arrays, split full arrays out to a TP
degree, and the qkv-aware variants that keep each rank's ``[q_i | k_i |
v_i]`` block contiguous. Each function takes numpy arrays or torch tensors
(on the CPU) and returns the same kind, with the same results."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _cat(parts, dim):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts), dim=dim)
    return np.concatenate([np.asarray(p) for p in parts], axis=dim)


def _split(a, n, dim):
    """``n`` equal pieces of ``a`` along ``dim`` (contiguous copies)."""
    if isinstance(a, torch.Tensor):
        return [p.contiguous() for p in torch.tensor_split(a, n, dim=dim)]
    return [np.ascontiguousarray(p) for p in np.split(np.asarray(a), n, axis=dim)]


def merge_tp_shards(shards: Sequence, dim: int):
    """Concatenate per-rank shards along the sharded dim (column-parallel:
    dim=last; row-parallel: dim=0)."""
    if len(shards) == 1:
        return shards[0] if isinstance(shards[0], torch.Tensor) else np.asarray(shards[0])
    return _cat(shards, dim)


def split_tp_shards(full, dim: int, tp_degree: int) -> List:
    """Split a full array into tp_degree equal shards along ``dim``."""
    if full.shape[dim] % tp_degree != 0:
        raise ValueError(f"dim {dim} of shape {tuple(full.shape)} not divisible by "
                         f"tp={tp_degree}")
    return _split(full, tp_degree, dim)


def merge_qkv_shards(shards: Sequence, dim: int, num_splits: int = 3):
    """Merge TP shards of a FUSED qkv weight: each rank's shard holds
    [q_i | k_i | v_i] along ``dim``, the merged weight is [q_0..q_n | k_0..k_n
    | v_0..v_n] (plain concatenation would interleave q/k/v)."""
    if len(shards) == 1:
        return merge_tp_shards(shards, dim)
    per_rank = [_split(s, num_splits, dim) for s in shards]
    return _cat([_cat([r[i] for r in per_rank], dim) for i in range(num_splits)], dim)


def split_qkv_shards(full, dim: int, tp_degree: int, num_splits: int = 3) -> List:
    """Inverse of :func:`merge_qkv_shards`: shard a fused qkv weight so each
    rank gets its contiguous [q_i | k_i | v_i] block."""
    parts = _split(full, num_splits, dim)
    for part in parts:
        if part.shape[dim] % tp_degree != 0:
            raise ValueError(f"qkv split dim {dim} of {tuple(part.shape)} not divisible "
                             f"by tp={tp_degree}")
    pieces = [_split(part, tp_degree, dim) for part in parts]
    return [_cat([p[rank] for p in pieces], dim) for rank in range(tp_degree)]


def partition_data(data: List, num_partitions: int) -> List[List]:
    """Even partitioning of a list."""
    if len(data) % num_partitions != 0:
        raise ValueError(f"cannot partition {len(data)} items into {num_partitions}")
    size = len(data) // num_partitions
    return [data[i * size:(i + 1) * size] for i in range(num_partitions)]
