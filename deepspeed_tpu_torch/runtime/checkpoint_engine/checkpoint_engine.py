"""The pluggable checkpoint-engine interface (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``): the
create / save / load / commit base class.

The JAX package's Orbax engines (``OrbaxCheckpointEngine``,
``AsyncCheckpointEngine``) write sharded ``jax.Array`` trees and have no torch
counterpart; they are refused by name. The port's engine-level save and load
use the crash-safe format of :mod:`.safe_engine`."""

from __future__ import annotations

from typing import Any

from deepspeed_tpu_torch.utils.not_ported import not_ported


class CheckpointEngine:

    def __init__(self, config_params=None):
        pass

    def create(self, tag: str):
        """Notify start of a checkpoint under ``tag``."""

    def save(self, state_dict: Any, path: str):
        raise NotImplementedError

    def load(self, path: str, map_location=None, template: Any = None):
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Flush/publish everything saved under ``tag``."""
        return True


class OrbaxCheckpointEngine(CheckpointEngine):

    def __init__(self, config_params=None):
        not_ported("the orbax checkpoint engine", "queue 1: checkpoint ingestion (orbax)")


class AsyncCheckpointEngine(OrbaxCheckpointEngine):
    pass
