from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.basic_layer import (
    RandomLayerTokenDrop, gather_tokens, scatter_tokens, token_sample)
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.scheduler import RandomLTDScheduler
