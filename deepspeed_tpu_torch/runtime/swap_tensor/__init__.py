from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import PartitionedOptimizerSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import \
    AsyncPartitionedParameterSwapper

__all__ = ["AsyncTensorSwapper", "PartitionedOptimizerSwapper",
           "AsyncPartitionedParameterSwapper"]
