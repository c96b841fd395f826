"""Block-sparse attention (reference ``deepspeed/ops/sparse_attention/``),
the counterpart of ``deepspeed_tpu/ops/sparse_attention/``.

The reference runs block-sparse attention on Triton kernels driven by a C++
LUT builder; the port expresses the same sparsity structures as block
layouts that the Hopper flash kernels A, C and D walk as live-tile lists,
with an exact dense token-bias form for small sequences and dense attention
masks.
"""

from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
    extend_position_embedding, pad_to_block_size, replace_self_attention,
    unpad_sequence_output)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, layout_to_token_bias, sparse_attention_core)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
    "LocalSlidingWindowSparsityConfig", "SparseSelfAttention", "layout_to_token_bias",
    "sparse_attention_core", "pad_to_block_size", "unpad_sequence_output",
    "extend_position_embedding", "replace_self_attention",
]
