"""Elastic batch-size planning (counterpart of
``deepspeed_tpu/elasticity/elasticity.py``, copied: host math only;
reference ``elasticity/elasticity.py``).

Given a maximum acceptable global batch size and a set of valid micro-batch
sizes, enumerate the composite global batch sizes that stay valid across a
range of chip counts — so training can resume after a world-size change
without changing effective hyperparameters. Algorithms follow the
reference's v0.1 (``:81``) and v0.2 (``:124``, adds
``num_gpus_per_node``-divisibility) semantics.
"""

from __future__ import annotations

from typing import Dict, List

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.elasticity.config import (ElasticityConfig, ElasticityConfigError,
                                             ElasticityError, ElasticityIncompatibleWorldSize)

# The 38 smallest highly composite numbers — enough to scale candidate
# batch sizes up to ~720K (the reference plans over the same constant set)
HCN_LIST = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680,
    2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400, 55440,
    83160, 110880, 166320, 221760, 277200, 332640, 498960, 554400, 665280,
    720720,
]


def get_candidate_batch_sizes(base_list: List[int], max_acceptable_batch_size: int) -> List[int]:
    """One candidate per base: the base scaled by the largest highly
    composite number that keeps it ≤ max (reference ``:25-37``) — HCN
    scaling maximizes the divisor count, hence the valid chip counts."""
    candidates = set()
    for base in base_list:
        if base >= max_acceptable_batch_size:
            candidates.add(base)
            continue
        limit = max_acceptable_batch_size // base
        hcn = max(h for h in HCN_LIST if h <= limit)
        candidates.add(hcn * base)
    return sorted(candidates)


def get_valid_gpus(batch_size: int, micro_batches: List[int],
                   min_valid_gpus: int, max_valid_gpus: int) -> List[int]:
    """Chip counts g in range where batch = m * gas * g for some micro-batch
    m — i.e. the divisors of batch/m (factor search in the reference,
    ``:39-58``; identical set, enumerated by range here)."""
    valid = []
    for g in range(min_valid_gpus, max_valid_gpus + 1):
        if any(batch_size % (g * m) == 0 for m in micro_batches):
            valid.append(g)
    return valid


def get_best_candidates(candidate_batch_sizes: List[int], micro_batches: List[int],
                        min_gpus: int, max_gpus: int, prefer_larger: bool):
    """The candidate with the most valid chip counts (ties → batch-size
    preference), reference ``:61-80``."""
    max_valid_gpus = 0
    best_batch = int(min(micro_batches))
    best_gpus = None
    for batch in candidate_batch_sizes:
        valid = get_valid_gpus(batch, micro_batches, min_gpus, max_gpus)
        if (len(valid) > max_valid_gpus
                or (len(valid) == max_valid_gpus
                    and ((prefer_larger and batch > best_batch)
                         or (not prefer_larger and batch < best_batch)))):
            max_valid_gpus = len(valid)
            best_batch = batch
            best_gpus = valid
    return best_batch, best_gpus


def _get_compatible_gpus_v01(micro_batches: List[int], max_acceptable_batch_size: int,
                             min_gpus: int, max_gpus: int, prefer_larger: bool):
    import math
    min_gpus = min_gpus or 1
    max_gpus = max_gpus or max_acceptable_batch_size // min(micro_batches)
    if not all(mb <= max_acceptable_batch_size for mb in micro_batches):
        raise ElasticityConfigError(
            f"All micro batches {micro_batches} must be <= "
            f"max_acceptable_batch_size {max_acceptable_batch_size}")
    # bases: each micro batch AND their lcm (reference ``:110-114``)
    lcm = math.lcm(*micro_batches)
    candidates = get_candidate_batch_sizes(list(micro_batches) + [lcm],
                                           max_acceptable_batch_size)
    return get_best_candidates(candidates, micro_batches, min_gpus, max_gpus, prefer_larger)


def _get_compatible_gpus_v02(micro_batches: List[int], max_acceptable_batch_size: int,
                             min_gpus: int, max_gpus: int, prefer_larger: bool,
                             num_gpus_per_node: int, model_parallel_size: int):
    """v0.2: chip counts are whole multiples of chips-per-node. The search
    runs at NODE granularity on a per-node-DP-scaled max batch, then the
    result is scaled back up — so the final batch stays divisible by every
    valid chip-level DP count (reference ``:124-188``)."""
    if num_gpus_per_node % model_parallel_size != 0:
        raise ElasticityConfigError(
            f"model_parallel_size {model_parallel_size} must divide "
            f"num_gpus_per_node {num_gpus_per_node}")
    dp_size_per_node = num_gpus_per_node // model_parallel_size

    per_node_batch, valid_nodes = _get_compatible_gpus_v01(
        micro_batches,
        max_acceptable_batch_size // dp_size_per_node,
        min_gpus=max(1, min_gpus // num_gpus_per_node),
        max_gpus=max(1, max_gpus // num_gpus_per_node),
        prefer_larger=prefer_larger)
    if not valid_nodes:
        return per_node_batch, []
    final_batch = per_node_batch * dp_size_per_node
    valid_gpus = [n * num_gpus_per_node for n in (valid_nodes or [])]
    return final_batch, valid_gpus


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0, return_microbatch: bool = False):
    """Resolve the elastic plan (reference ``:231``).

    Without ``world_size``: returns ``(final_batch_size, valid_world_sizes)``.
    With ``world_size``: returns ``(final_batch_size, micro_batch, gas)`` —
    or with ``return_microbatch`` the chosen micro batch alone.
    """
    elastic_config_dict = ds_config.get(C.ELASTICITY, {})
    elastic_config = ElasticityConfig(elastic_config_dict)
    if not elastic_config.enabled:
        raise ElasticityError("Elasticity is not enabled in the provided config")

    if float(elastic_config.version) == 0.1:
        final_batch_size, valid_gpus = _get_compatible_gpus_v01(
            elastic_config.micro_batches, elastic_config.max_acceptable_batch_size,
            elastic_config.min_gpus, elastic_config.max_gpus,
            elastic_config.prefer_larger_batch_size)
    elif float(elastic_config.version) == 0.2:
        final_batch_size, valid_gpus = _get_compatible_gpus_v02(
            elastic_config.micro_batches, elastic_config.max_acceptable_batch_size,
            elastic_config.min_gpus, elastic_config.max_gpus,
            elastic_config.prefer_larger_batch_size, elastic_config.num_gpus_per_node,
            elastic_config.model_parallel_size)
    else:
        raise ElasticityConfigError(f"Unknown elasticity version {elastic_config.version}")

    if final_batch_size is None or not valid_gpus:
        raise ElasticityError(
            f"No valid batch size found for micro batches {elastic_config.micro_batches} "
            f"within max batch {elastic_config.max_acceptable_batch_size}")

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"World size {world_size} is not valid for this elastic config; "
                f"valid world sizes: {valid_gpus}")
        # pick the largest micro batch that divides the per-replica batch
        dp = world_size // elastic_config.model_parallel_size if float(
            elastic_config.version) == 0.2 else world_size
        if final_batch_size % dp != 0:
            raise ElasticityIncompatibleWorldSize(
                f"batch {final_batch_size} does not divide across dp={dp}")
        per_replica = final_batch_size // dp
        candidates = [m for m in elastic_config.micro_batches if per_replica % m == 0]
        if not candidates:
            raise ElasticityIncompatibleWorldSize(
                f"no micro batch in {elastic_config.micro_batches} divides the "
                f"per-replica batch {per_replica} at world size {world_size}")
        micro = (max(candidates) if elastic_config.prefer_larger_batch_size
                 else min(candidates))
        gas = per_replica // micro
        if return_microbatch:
            return micro
        return final_batch_size, micro, gas

    return final_batch_size, valid_gpus


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict) -> None:
    """Guard against changing the elastic config mid-job via env-propagated
    snapshot (reference ``:202-230``)."""
    import json
    import os

    env_key = "DEEPSPEED_ELASTICITY_CONFIG"
    if env_key in os.environ:
        scheduler_config = json.loads(os.environ[env_key])
        if scheduler_config != runtime_elastic_config_dict:
            raise ElasticityConfigError(
                "Elastic config changed between scheduler and runtime; "
                "this would corrupt elastic checkpoints")
    else:
        os.environ[env_key] = json.dumps(runtime_elastic_config_dict)
