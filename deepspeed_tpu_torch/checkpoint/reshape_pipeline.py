"""Offline pipeline-degree reshaping of engine checkpoints (the port's copy
of ``deepspeed_tpu/checkpoint/reshape_pipeline.py``).

The tree functions re-stack a pipeline's stage axis: every ``stages`` leaf
``[S, layers_per_stage, ...]`` <-> ``[n_layer, ...]``, over nested dicts and
lists of numpy arrays or torch tensors. ``reshape_pipeline_checkpoint``
writes an orbax tag, the JAX pipeline engine's format; the port has no
pipeline engine yet, so it raises naming that item."""

from __future__ import annotations

from typing import Any, Optional

from deepspeed_tpu_torch.models.transformer import map_tree as _map
from deepspeed_tpu_torch.utils.not_ported import not_ported


def stages_to_layers(tree: Any):
    """Stage-stacked subtree [S, Lps, ...] -> flat layer-stacked [L, ...]."""
    return _map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), tree)


def layers_to_stages(tree: Any, num_stages: int):
    """Flat layer-stacked subtree [L, ...] -> [num_stages, L/num_stages, ...]."""
    def one(a):
        if a.shape[0] % num_stages:
            raise ValueError(f"n_layer {a.shape[0]} not divisible by "
                             f"target pp degree {num_stages}")
        return a.reshape((num_stages, a.shape[0] // num_stages) + tuple(a.shape[1:]))

    return _map(one, tree)


def _reshape_leaf(a, target_pp: int):
    L = a.shape[0] * a.shape[1]
    if L % target_pp:
        raise ValueError(f"n_layer {L} not divisible by target pp {target_pp}")
    return a.reshape((target_pp, L // target_pp) + tuple(a.shape[2:]))


def reshape_stages_tree(stages: Any, target_pp: int):
    """[S, Lps, ...] stage leaves re-stacked to the target pp degree."""
    return _map(lambda a: _reshape_leaf(a, target_pp), stages)


def reshape_pipeline_checkpoint(src_dir: str, dst_dir: str, target_pp: int,
                                tag: Optional[str] = None) -> str:
    """The JAX tool rewrites a pipeline tag at another pp degree as an orbax
    tag for its pipeline engine; the port has neither yet."""
    not_ported("reshape_pipeline_checkpoint (an orbax tag for the pipeline engine)",
               "queue 1: runtime/pipe/")
