"""Elasticity: batch-size planning valid across changing device counts
(counterpart of ``deepspeed_tpu/elasticity/``). The elastic agent, which
spawns and restarts ranks, comes after the launcher: its names raise the
refusal of ROADMAP.md queue 1 "elasticity/elastic_agent.py"."""

from deepspeed_tpu_torch.elasticity.config import (ElasticityConfig, ElasticityConfigError,
                                                   ElasticityError,
                                                   ElasticityIncompatibleWorldSize)
from deepspeed_tpu_torch.elasticity.elasticity import (HCN_LIST, compute_elastic_config,
                                                       ensure_immutable_elastic_config,
                                                       get_candidate_batch_sizes,
                                                       get_valid_gpus)

__all__ = [
    "ElasticityConfig", "ElasticityError", "ElasticityConfigError",
    "ElasticityIncompatibleWorldSize", "HCN_LIST", "compute_elastic_config",
    "ensure_immutable_elastic_config", "get_candidate_batch_sizes", "get_valid_gpus",
]

_AGENT = ("DSElasticAgent", "WorkerSpec", "WorkerState", "RunResult")


def __getattr__(name):
    if name in _AGENT:
        from deepspeed_tpu_torch.utils.not_ported import not_ported
        not_ported(f"the elastic agent ({name})", "queue 1: elasticity/elastic_agent.py")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
