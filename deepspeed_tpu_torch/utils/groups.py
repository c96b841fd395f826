"""Parallel-group bookkeeping over mesh axes (counterpart of
``deepspeed_tpu/utils/groups.py``): the reference's expert, data and model
group accessors, returning axis names that ``deepspeed_tpu_torch.comm``
collectives accept as ``group=``, and the checks of an EP x DP (x TP)
decomposition against the live mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import deepspeed_tpu_torch.comm as dist

# axis-name conventions (see comm/mesh.py CANONICAL_AXIS_ORDER)
EXPERT_AXIS = "ep"
DATA_AXES = ("dp", "fsdp")
MODEL_AXIS = "tp"
PIPE_AXIS = "pp"
SEQUENCE_AXIS = "sp"

_expert_group_registry: Dict[str, str] = {}


def _mesh():
    return dist.get_mesh()


def initialize(ep_size: int = 1, mpu=None) -> None:
    """Validate that the live mesh supports ``ep_size`` expert parallelism
    (reference groups.initialize). The mesh's ``ep`` axis must equal ep_size
    (or be absent for ep_size=1)."""
    mesh = _mesh()
    actual = mesh.shape.get(EXPERT_AXIS, 1)
    if actual != ep_size:
        raise ValueError(f"mesh ep axis size {actual} != requested ep_size {ep_size}; "
                         f"build the mesh with axes={{'ep': {ep_size}, ...}}")
    _expert_group_registry[f"ep_size_{ep_size}"] = EXPERT_AXIS


def _create_expert_and_data_parallel(ep_size: int) -> None:
    initialize(ep_size)


def _create_expert_data_and_model_parallel(ep_size: int, mpu=None) -> None:
    initialize(ep_size)
    mesh = _mesh()
    if MODEL_AXIS not in mesh.shape:
        raise ValueError("expert+model parallel needs a tp axis in the mesh")


def _get_expert_parallel_group(group_name: str = ""):
    return EXPERT_AXIS


def _get_expert_parallel_group_dict() -> Dict[str, str]:
    return dict(_expert_group_registry) or {"default": EXPERT_AXIS}


def _get_expert_data_parallel_group(group_name: str = ""):
    """Axes over which NON-expert state of expert params replicates — the dp
    axes excluding ep (reference: expert-data-parallel group)."""
    mesh = _mesh()
    return tuple(a for a in DATA_AXES if a in mesh.shape)


def _get_data_parallel_group():
    mesh = _mesh()
    return tuple(a for a in DATA_AXES if a in mesh.shape)


def _get_model_parallel_group():
    return MODEL_AXIS


def _get_expert_parallel_world_size(group_name: str = "") -> int:
    return dist.get_world_size(EXPERT_AXIS)


def _get_expert_data_parallel_world_size(group_name: str = "") -> int:
    return dist.get_world_size(_get_expert_data_parallel_group())


def _get_expert_parallel_rank(group_name: str = "") -> int:
    return dist.get_rank(EXPERT_AXIS)


def _get_data_parallel_world_size() -> int:
    return dist.get_world_size(_get_data_parallel_group())


def _get_model_parallel_world_size() -> int:
    return dist.get_world_size(MODEL_AXIS)


def expert_sharding_axes(ep_size: int, num_experts: int) -> Tuple[Optional[str], int]:
    """(axis to shard the expert dim over, local experts per device)."""
    if ep_size <= 1:
        return None, num_experts
    return EXPERT_AXIS, num_experts // ep_size
