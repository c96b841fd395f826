"""Sparse-attention op surface: the counterpart of
``deepspeed_tpu/ops/sparse_attention/kernels.py`` (reference Triton
block-sparse sdd / dsd matmuls with LUTs, ``softmax.py``, and the C++ LUT
builder ``csrc/sparse_attention/utils.cpp``).

The LUT machinery exists to skip zero blocks in a hand-written GPU kernel.
Here the flash kernels A, C and D take the block layout directly
(``flash_attention(block_layout=...)``): the wrapper turns it into live-tile
lists, one per (head, tile row), which the kernels' producer and consumers
walk, so the LUT builder is ``ops/kernels/flash_attention.live_tiles`` and
:meth:`SparsityConfig.make_layout`. This module is the named-op home: layout
construction and the layout-aware attention call.
"""

from __future__ import annotations

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, layout_to_token_bias)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)

__all__ = ["SparseSelfAttention", "layout_to_token_bias", "SparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig"]
