"""Row-sparse gradients and their data-parallel reduction (counterpart of
``deepspeed_tpu/runtime/sparse_tensor.py``; reference
``deepspeed/runtime/sparse_tensor.py`` and the engine's sparse allreduce).

For a large vocabulary only the rows of a batch's tokens carry an embedding
gradient. :class:`SparseTensor` holds ``(indices [nnz], values [nnz, row],
dense_shape)`` with duplicates allowed (they add on densify, as torch's
uncoalesced sparse tensors do). :func:`sparse_all_reduce` gathers every
rank's indices and values over the group through ``comm`` (each rank
passes its own): ``world * nnz * row`` elements on the wire where a dense
all-reduce moves ``vocab * row``, the reference's trade.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

import deepspeed_tpu_torch.comm as dist


@dataclasses.dataclass
class SparseTensor:
    """Row-sparse 2-D tensor: ``dense[indices[i]] += values[i]``."""
    indices: torch.Tensor                 # [nnz] int64 row ids (duplicates allowed)
    values: torch.Tensor                  # [nnz, row_dim]
    dense_shape: Tuple[int, int]

    @staticmethod
    def from_embedding_grad(token_ids, row_grads, vocab_size: int) -> "SparseTensor":
        """Batch tokens ``[N]`` and their grad rows ``[N, D]`` -> the sparse
        grad of the ``[vocab, D]`` embedding."""
        token_ids = torch.as_tensor(token_ids).reshape(-1).long()
        row_grads = torch.as_tensor(row_grads).reshape(token_ids.shape[0], -1)
        return SparseTensor(token_ids, row_grads, (int(vocab_size), row_grads.shape[1]))

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.indices, self.values)

    def to_coo_tensor(self):
        """Reference-named alias: ``(indices, values, dense_shape)``."""
        return self.indices, self.values, self.dense_shape

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]


def sparse_all_reduce(st: SparseTensor, group="dp", average: bool = True) -> SparseTensor:
    """Every rank's (indices, values) gathered over ``group`` (a mesh axis
    or axes): the uncoalesced sum of the ranks' contributions, divided by
    the group's size with ``average``."""
    idx = dist.all_gather(st.indices, group=group)
    vals = dist.all_gather(st.values, group=group)
    if average:
        vals = vals / dist.get_world_size(group)
    return SparseTensor(idx, vals, st.dense_shape)


__all__ = ["SparseTensor", "sparse_all_reduce"]
