from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.kv_host_pool import KvHostPool
from deepspeed_tpu_torch.inference.serve import AsyncServingEngine, RequestHandle

__all__ = ["AsyncServingEngine", "DeepSpeedInferenceConfig", "InferenceEngine", "KvHostPool",
           "RequestHandle"]
