"""Generic causal-LM wrapper over the shared transformer backbone
(counterpart of ``deepspeed_tpu/models/causal_lm.py``: the serving surface
and the training loss)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from deepspeed_tpu_torch.models import transformer as T


class CausalLM(nn.Module):
    """A causal language model for ``initialize`` and ``init_inference``.
    Like the JAX class it holds the config, not the weights: the parameter
    tree (a :class:`~deepspeed_tpu_torch.models.transformer.ParamTree`) is
    made by :meth:`init_params` or loaded, and passed to every forward.

    batch: dict(input_ids ``[B, S]``, optional labels, attention_mask)."""

    def __init__(self, config: T.TransformerConfig, param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.param_dtype = param_dtype

    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=None) -> T.ParamTree:
        return T.init_params(self.config, generator, device,
                             self.param_dtype if dtype is None else dtype)

    def forward(self, params, tokens, attn_mask=None):
        return T.forward(self.config, params, tokens, attn_mask)

    def loss(self, params, batch, rng: Optional[torch.Generator] = None):
        """Training loss; ``rng`` (threaded by the engine's train path)
        enables cfg.dropout, eval paths pass None and stay deterministic."""
        return T.lm_loss(self.config, params, batch, rng=rng)

    @property
    def num_parameters(self) -> int:
        cfg = self.config
        embed = cfg.vocab_size * cfg.d_model + (cfg.max_seq * cfg.d_model if cfg.pos_embedding == "learned" else 0)
        attn = cfg.d_model * cfg.head_dim * (cfg.n_head + 2 * cfg.kv_heads) + cfg.n_head * cfg.head_dim * cfg.d_model
        if cfg.attn_bias:
            attn += cfg.head_dim * (cfg.n_head + 2 * cfg.kv_heads) + cfg.d_model
        if cfg.activation == "swiglu":
            mlp = 3 * cfg.d_model * cfg.ff_dim
        else:
            mlp = 2 * cfg.d_model * cfg.ff_dim + cfg.ff_dim + cfg.d_model
        norms = (4 if cfg.norm == "layernorm" else 2) * cfg.d_model
        final_norm = (2 if cfg.norm == "layernorm" else 1) * cfg.d_model
        if cfg.embed_layernorm:
            final_norm += (2 if cfg.norm == "layernorm" else 1) * cfg.d_model
        head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size
        return embed + cfg.n_layer * (attn + mlp + norms) + final_norm + head

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approximate training FLOPs/token (6N + attention term)."""
        cfg = self.config
        s = seq_len or cfg.max_seq
        return 6.0 * self.num_parameters + 12.0 * cfg.n_layer * cfg.d_model * s

    # ---- KV-cache inference (see transformer.forward_cached) ----

    def init_cache(self, batch_size: int, max_len: Optional[int] = None, dtype=torch.bfloat16,
                   device="cpu") -> Dict[str, torch.Tensor]:
        return T.init_kv_cache(self.config, batch_size, max_len, dtype, device)

    def forward_cached(self, params, tokens, cache, pos: int, pad_bias=None):
        return T.forward_cached(self.config, params, tokens, cache, pos, pad_bias)

    # ---- paged KV serving (see transformer.forward_paged_*) ----

    def init_paged_cache(self, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                         device="cpu") -> Dict[str, torch.Tensor]:
        return T.init_paged_kv_cache(self.config, num_blocks, block_size, dtype, device)

    def forward_paged_prefill(self, params, tokens, pools, slots, last_idx):
        return T.forward_paged_prefill(self.config, params, tokens, pools, slots, last_idx)

    def forward_paged_prefill_chunk(self, params, tokens, pools, block_tables, slots,
                                    start_pos, last_idx):
        return T.forward_paged_prefill_chunk(self.config, params, tokens, pools,
                                             block_tables, slots, start_pos, last_idx)

    def forward_paged_decode(self, params, tokens, pools, block_tables, pos, pad_bias=None):
        return T.forward_paged_decode(self.config, params, tokens, pools, block_tables, pos,
                                      pad_bias)
