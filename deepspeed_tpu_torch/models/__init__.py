from deepspeed_tpu_torch.models.causal_lm import CausalLM
from deepspeed_tpu_torch.models.presets import gpt2, llama
from deepspeed_tpu_torch.models.transformer import ParamTree, TransformerConfig

__all__ = ["CausalLM", "ParamTree", "TransformerConfig", "gpt2", "llama"]
