"""Generic causal-LM wrapper over the shared transformer backbone
(counterpart of ``deepspeed_tpu/models/causal_lm.py``, serving surface)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from deepspeed_tpu_torch.models import transformer as T


class CausalLM(nn.Module):
    """A causal language model for ``init_inference``. Like the JAX class it
    holds the config, not the weights: the parameter tree (a
    :class:`~deepspeed_tpu_torch.models.transformer.ParamTree`) is made by
    :meth:`init_params` or loaded, and passed to every forward."""

    def __init__(self, config: T.TransformerConfig, param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.param_dtype = param_dtype

    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=None) -> T.ParamTree:
        return T.init_params(self.config, generator, device,
                             self.param_dtype if dtype is None else dtype)

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
