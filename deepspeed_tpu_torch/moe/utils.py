"""MoE parameter classification (counterpart of ``deepspeed_tpu/moe/utils.py``;
reference ``deepspeed/moe/utils.py`` ``is_moe_param``).

Expert leaves live under an ``"experts"`` key. The JAX package uses the
split to keep ZeRO's data-parallel sharding off the ``ep`` mesh axis; at
expert parallelism 1 the port has no such axis, so nothing in its training
engine splits by it. The zoo's :class:`~deepspeed_tpu_torch.models.moe_lm.MoECausalLM`
keeps its experts as ``mlp`` leaves (``w_up`` ``[E, D, F]`` ...), as the JAX
model does, so its leaves all read as dense here too."""

from __future__ import annotations

from typing import Any, List, Tuple

from torch import nn

from deepspeed_tpu_torch.utils.pytree import leaf_paths


def is_moe_param_path(path) -> bool:
    """True if a key path (keys, or objects with ``.key`` / ``.name`` as
    JAX's path entries have; a dotted name also works) belongs to an expert
    parameter."""
    if isinstance(path, str):
        path = path.split(".")
    return any(getattr(k, "key", getattr(k, "name", k)) == "experts" for k in path)


def split_moe_params(params: Any) -> Tuple[List, List]:
    """``(expert_leaves, dense_leaves)`` of a ParamTree (its parameters) or
    a nested dict / list tree of tensors, by key path."""
    if isinstance(params, nn.Module):
        items = params.named_parameters()
    else:
        items = leaf_paths(params, descend_sequences=True).items()
    expert, dense = [], []
    for name, leaf in items:
        (expert if is_moe_param_path(name) else dense).append(leaf)
    return expert, dense


def has_moe_layers(model) -> Tuple[bool, int]:
    """``(has_moe, num_experts)`` for an engine-visible model."""
    moe = getattr(model, "moe", None)
    if moe is not None:
        return True, getattr(moe, "num_experts", 0)
    if getattr(model, "num_experts", 0):
        return True, model.num_experts
    return False, 0
