"""Elasticity (counterpart of ``deepspeed_tpu/elasticity/``): batch-size
planning valid across changing device counts, and the elastic agent that
spawns and restarts a node's ranks."""

from deepspeed_tpu_torch.elasticity.config import (ElasticityConfig, ElasticityConfigError,
                                                   ElasticityError,
                                                   ElasticityIncompatibleWorldSize)
from deepspeed_tpu_torch.elasticity.elastic_agent import (DSElasticAgent, RunResult, WorkerSpec,
                                                          WorkerState)
from deepspeed_tpu_torch.elasticity.elasticity import (HCN_LIST, compute_elastic_config,
                                                       ensure_immutable_elastic_config,
                                                       get_candidate_batch_sizes,
                                                       get_valid_gpus)

__all__ = [
    "ElasticityConfig", "ElasticityError", "ElasticityConfigError",
    "ElasticityIncompatibleWorldSize", "HCN_LIST", "compute_elastic_config",
    "ensure_immutable_elastic_config", "get_candidate_batch_sizes", "get_valid_gpus",
    "DSElasticAgent", "RunResult", "WorkerSpec", "WorkerState",
]
