from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.serve import AsyncServingEngine, RequestHandle

__all__ = ["AsyncServingEngine", "DeepSpeedInferenceConfig", "InferenceEngine", "RequestHandle"]
