"""Activation checkpointing config (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/config.py``).

``cpu_checkpointing`` selects the offload policy of
:func:`~deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing.checkpoint`;
on one device the other fields are recorded with no effect, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepspeed_tpu_torch.config.config_utils import ConfigModel


@dataclasses.dataclass(init=False)
class DeepSpeedActivationCheckpointingConfig(ConfigModel):
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
