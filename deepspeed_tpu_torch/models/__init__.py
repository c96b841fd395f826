from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
from deepspeed_tpu_torch.models.causal_lm import CausalLM
from deepspeed_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig,
                                             CLIPVisionEncoder, DSClipEncoder)
from deepspeed_tpu_torch.models.diffusers_wrappers import DSUNet, DSVAE
from deepspeed_tpu_torch.models.presets import (MODEL_PRESETS, bloom, get_model, gpt2, gpt2_large,
                                                gpt2_medium, gpt2_xl, gpt_neox, llama, llama_7b,
                                                opt)
from deepspeed_tpu_torch.models.transformer import ParamTree, TransformerConfig

__all__ = ["BertConfig", "BertModel", "CLIPTextConfig", "CLIPTextEncoder", "CLIPVisionConfig",
           "CLIPVisionEncoder", "CausalLM", "DSClipEncoder", "DSUNet", "DSVAE", "MODEL_PRESETS",
           "ParamTree", "TransformerConfig", "bloom", "get_model", "gpt2", "gpt2_large",
           "gpt2_medium", "gpt2_xl", "gpt_neox", "llama", "llama_7b", "opt"]
