from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine"]
