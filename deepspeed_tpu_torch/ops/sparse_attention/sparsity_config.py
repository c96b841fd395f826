"""Block-sparsity layout configs: the counterpart of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (reference
``ops/sparse_attention/sparsity_config.py``: Dense / Fixed / Variable /
BigBird / BSLongformer / LocalSlidingWindow).

Each config makes ``make_layout(seq_len)``: an int64 ``[num_heads, nb, nb]``
CPU tensor with 1 where a (query block, key block) pair attends. The
layouts are bit-equal to the JAX package's (the random blocks draw from
``random.Random(0)`` in the same order). They feed the block-sparse flash
kernels (``flash_attention(block_layout=...)``) or the dense token-bias
form of :mod:`.sparse_self_attention`. Default ``block=128``: a layout
block then covers whole tiles of the Hopper kernels, so none straddles.
"""

from __future__ import annotations

import random
from typing import List, Optional

import torch


class SparsityConfig:
    """Base (reference ``:34``): head count, block size, per-head layouts."""

    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> torch.Tensor:
        if seq_len % self.block != 0:
            raise ValueError(f"seq len {seq_len} must be divisible by block {self.block}")
        nb = seq_len // self.block
        return torch.zeros((self.num_heads, nb, nb), dtype=torch.int64)

    def check_and_propagate_first_head_layout(self, layout: torch.Tensor) -> torch.Tensor:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def _finish(self, layout: torch.Tensor) -> torch.Tensor:
        layout = self.check_and_propagate_first_head_layout(layout)
        if getattr(self, "attention", None) == "unidirectional":
            layout = torch.tril(layout)
        return layout

    def make_layout(self, seq_len: int) -> torch.Tensor:
        raise NotImplementedError


def _global_cols(indices: List[int], end_indices: Optional[List[int]]) -> List[int]:
    if end_indices is None:
        return list(indices)
    cols = []
    for lo, hi in zip(indices, end_indices):
        cols.extend(range(lo, hi))
    return cols


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend (reference ``:125``)."""

    def make_layout(self, seq_len: int) -> torch.Tensor:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks (reference ``:155``)."""

    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional", horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni/bidirectional")
        self.attention = attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional attention")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("different global patterns require different_layout_per_head")
        self.num_different_global_patterns = num_different_global_patterns

    def _set_local(self, layout: torch.Tensor, h: int) -> None:
        nb = layout.shape[1]
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            for r in range(start, end):
                hi = (r + 1) if self.attention == "unidirectional" else end
                layout[h, r, start:hi] = 1

    def _set_global(self, layout: torch.Tensor, h: int) -> None:
        nb = layout.shape[1]
        first = (h // max(1, self.num_heads // self.num_different_global_patterns)
                 ) % self.num_different_global_patterns
        # the last num_global_blocks of each local window (offset per pattern)
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            g_lo = start + (first + 1) * (self.num_local_blocks // self.num_global_blocks) \
                - self.num_global_blocks
            g_lo = min(max(g_lo, start), end - self.num_global_blocks)
            g_hi = g_lo + self.num_global_blocks
            # vertical: every row (unidirectional: every later row) attends
            # the global blocks
            first_row = g_lo if self.attention == "unidirectional" else 0
            layout[h, first_row:, g_lo:g_hi] = 1
            if self.horizontal_global_attention:
                layout[h, g_lo:g_hi, :] = 1

    def make_layout(self, seq_len: int) -> torch.Tensor:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self._set_local(layout, h)
            self._set_global(layout, h)
        return self._finish(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + variable local windows + explicit global blocks
    (reference ``:303``)."""

    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False,
                 num_random_blocks: int = 0, local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional", horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> torch.Tensor:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = random.Random(0)
        for h in range(self.num_layout_heads):
            # variable local windows, cycling the last size
            start, i = 0, 0
            while start < nb:
                size = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + size, nb)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:hi] = 1
                start = end
                i += 1
            for r in range(nb):
                for _ in range(self.num_random_blocks):
                    layout[h, r, rng.randrange(nb)] = 1
            for c in _global_cols(self.global_block_indices, self.global_block_end_indices):
                if c < nb:
                    layout[h, :, c] = 1
                    if self.horizontal_global_attention:
                        layout[h, c, :] = 1
        return self._finish(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global (reference ``:496``)."""

    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> torch.Tensor:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(f"need >= {self.num_sliding_window_blocks} blocks, got {nb}")
        rng = random.Random(0)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for r in range(nb):
                layout[h, r, max(0, r - w):min(nb, r + w + 1)] = 1
                for _ in range(self.num_random_blocks):
                    layout[h, r, rng.randrange(nb)] = 1
            g = self.num_global_blocks
            layout[h, :, :g] = 1
            layout[h, :g, :] = 1
        return self._finish(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + explicit global indices (reference ``:585``)."""

    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> torch.Tensor:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for r in range(nb):
                layout[h, r, max(0, r - w):min(nb, r + w + 1)] = 1
            for c in _global_cols(self.global_block_indices, self.global_block_end_indices):
                if c < nb:
                    layout[h, :, c] = 1
                    layout[h, c, :] = 1
        return self._finish(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference ``:678``)."""

    def __init__(self, num_heads: int, block: int = 128,
                 num_sliding_window_blocks: int = 3, attention: str = "unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> torch.Tensor:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for r in range(nb):
            lo = max(0, r - w)
            hi = min(nb, r + w + 1) if self.attention == "bidirectional" else r + 1
            layout[0, r, lo:hi] = 1
        return self._finish(layout)
