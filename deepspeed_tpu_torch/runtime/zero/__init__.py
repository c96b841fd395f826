"""ZeRO (counterpart of ``deepspeed_tpu/runtime/zero/``): the config, the
partition rules and flat units, construct-time partitioning (``Init``),
``GatheredParameters``, the engine's partitioned state, ``TiledLinear`` and
the host optimizer of ZeRO-Offload."""

from deepspeed_tpu_torch.runtime.zero.config import ZeroConfig
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime.zero.partition import ZeroShardingRules
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (
    GatheredParameters, Init, PartitionedParams, active_init)

__all__ = ["HostOffloadOptimizer", "Init", "GatheredParameters", "PartitionedParams",
           "ZeroConfig", "ZeroShardingRules", "active_init"]
