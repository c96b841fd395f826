"""HF and Megatron checkpoint ingestion (the port's copy of
``deepspeed_tpu/module_inject/``): per-architecture policies map HF tensor
names to the port's parameter tree ([in, out] weights, fused qkv
de-interleaved per head, one sub-tree per layer), and the loader streams
multi-file safetensors / torch checkpoints tensor by tensor onto the
device."""

from deepspeed_tpu_torch.module_inject.loader import load_hf_checkpoint
from deepspeed_tpu_torch.module_inject.policies import POLICIES, policy_for

__all__ = ["load_hf_checkpoint", "POLICIES", "policy_for"]
