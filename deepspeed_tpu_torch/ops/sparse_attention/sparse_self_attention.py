"""Sparse self-attention op: the counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py`` (reference
``ops/sparse_attention/sparse_self_attention.py`` and the Triton block-sparse
matmul / softmax kernels it drives).

Two execution paths, both computing softmax over the layout's support
exactly, both differentiable:

- **kernel** (the JAX package's "pallas" path): block-sparse flash
  attention, ``flash_attention(block_layout=...)``. On a CUDA tensor that
  runs the Hopper kernels A, C and D over each (head, tile) row's live-tile
  list, so dead blocks cost neither bytes nor products; on a CPU tensor the
  kernels' plain layout-aware versions.
- **dense**: the layout expanded to a token-level additive bias over one
  einsum attention (materialises ``[B, H, S, S]``, so it refuses S past
  :data:`DENSE_SPARSE_MAX_SEQ`).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (FixedSparsityConfig,
                                                                      SparsityConfig)


def layout_to_token_bias(layout, block: int, seq_len: int) -> torch.Tensor:
    """``[H, nb, nb]`` 0/1 layout -> additive fp32 bias ``[H, S, S]`` (0 keep,
    -1e9 drop)."""
    nb = seq_len // block
    lay = torch.as_tensor(layout)[:, :nb, :nb]
    tok = lay.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)
    return torch.where(tok > 0, 0.0, -1e9).float()


class SparseSelfAttention:
    """Callable op (reference ``:24``): q/k/v ``[B, S, H, Hd]`` -> ``[B, S,
    H, Hd]``. ``sparsity_config`` decides the layout; causal masking composes
    with it for "unidirectional" configs. ``backend``: "pallas" (the kernel
    path, the JAX package's name for it), "dense", or "auto" (the kernels on
    a CUDA tensor when the layout block is >= 128)."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add", attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048, backend: str = "auto"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        if backend not in ("auto", "pallas", "dense"):
            raise ValueError(f"backend={backend!r}; expected auto, pallas or dense")
        self.backend = backend
        self._layouts = {}

    def get_layout(self, seq_len: int) -> torch.Tensor:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def _use_kernels(self, query) -> bool:
        if self.backend == "pallas":
            return True
        if self.backend == "dense":
            return False
        return query.is_cuda and self.sparsity_config.block >= 128

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None, attn_mask=None):
        S = query.shape[1]
        layout = self.get_layout(S)
        causal = getattr(self.sparsity_config, "attention", "bidirectional") == "unidirectional"
        mask_bias = None
        if key_padding_mask is not None:
            # [B, S]: additive when floating, else 1 = keep
            if key_padding_mask.is_floating_point():
                mask_bias = key_padding_mask.float()
            else:
                mask_bias = torch.where(key_padding_mask > 0, 0.0, -1e9).float()
        extra = None
        if attn_mask is not None:
            extra = torch.where(attn_mask > 0, 0.0, -1e9).float()
        return sparse_attention_core(query, key, value, layout, self.sparsity_config.block,
                                     causal, mask_bias, use_pallas=self._use_kernels(query),
                                     attn_bias=extra)


# beyond this, the dense form's [B, H, S, S] logits defeat the purpose of
# sparsity: it refuses (as the JAX package does)
DENSE_SPARSE_MAX_SEQ = 4096


def sparse_attention_core(q, k, v, layout, block: int, causal: bool, mask_bias=None, *,
                          scale: Optional[float] = None, use_pallas: bool, attn_bias=None):
    """q/k/v ``[B, S, H, Hd]`` and an ``[H, nb, nb]`` layout -> ``[B, S, H,
    Hd]``. ``use_pallas`` and no dense ``attn_bias``: block-sparse flash
    attention (zero blocks skipped forward and backward); otherwise the
    exact dense token-bias einsum. Used by :class:`SparseSelfAttention` and
    by the model-level ``sparse_attention`` config (``models/transformer.py``)."""
    B, S, H, Hd = q.shape
    if use_pallas and attn_bias is None:
        from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, mask_bias=mask_bias, causal=causal, scale=scale,
                               block_layout=torch.as_tensor(layout))
    if S > DENSE_SPARSE_MAX_SEQ:
        raise NotImplementedError(
            f"sparse attention at S={S} > {DENSE_SPARSE_MAX_SEQ} needs the "
            "block-sparse kernel path (block >= 128, no dense attn_mask); the "
            "exact dense form would materialise the full score matrix")
    bias = layout_to_token_bias(layout, block, S).to(q.device)
    scale = Hd**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits + bias[None]
    if causal:
        cm = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm, logits, torch.full_like(logits, -1e9))
    if mask_bias is not None:
        logits = logits + mask_bias.float()[:, None, None, :]
    if attn_bias is not None:
        logits = logits + attn_bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
