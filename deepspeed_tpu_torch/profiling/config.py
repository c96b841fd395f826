"""FLOPS profiler config (counterpart of ``deepspeed_tpu/profiling/config.py``;
reference ``deepspeed/profiling/config.py``), with the JAX defaults."""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepspeed_tpu_torch.config.config_utils import ConfigModel


@dataclasses.dataclass(init=False)
class DeepSpeedFlopsProfilerConfig(ConfigModel):
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None
