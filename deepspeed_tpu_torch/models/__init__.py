from deepspeed_tpu_torch.models.causal_lm import CausalLM
from deepspeed_tpu_torch.models.presets import (MODEL_PRESETS, bloom, get_model, gpt2, gpt2_large,
                                                gpt2_medium, gpt2_xl, gpt_neox, llama, llama_7b,
                                                opt)
from deepspeed_tpu_torch.models.transformer import ParamTree, TransformerConfig

__all__ = ["CausalLM", "MODEL_PRESETS", "ParamTree", "TransformerConfig", "bloom", "get_model",
           "gpt2", "gpt2_large", "gpt2_medium", "gpt2_xl", "gpt_neox", "llama", "llama_7b", "opt"]
