"""Mixture-of-experts at expert parallelism 1 (counterpart of
``deepspeed_tpu/moe/``, reference ``deepspeed/moe/``)."""

from deepspeed_tpu_torch.moe.experts import ExpertFFN
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import (MOELayer, TopKGate, dispatch_combine,
                                                 top1gating, top2gating)
from deepspeed_tpu_torch.moe.utils import has_moe_layers, is_moe_param_path, split_moe_params

__all__ = ["MoE", "ExpertFFN", "MOELayer", "TopKGate", "dispatch_combine", "top1gating",
           "top2gating", "is_moe_param_path", "split_moe_params", "has_moe_layers"]
