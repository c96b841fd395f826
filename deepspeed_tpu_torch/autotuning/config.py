"""``"autotuning"`` config section (counterpart of
``deepspeed_tpu/autotuning/config.py``; reference
``deepspeed/autotuning/config.py`` and ``constants.py``), with the JAX
package's key names, defaults and bounds."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from deepspeed_tpu_torch.config.config_utils import ConfigModel
from deepspeed_tpu_torch.utils.not_ported import not_ported

AUTOTUNING = "autotuning"

METRIC_THROUGHPUT = "throughput"
METRIC_LATENCY = "latency"

TUNER_GRIDSEARCH = "gridsearch"
TUNER_RANDOM = "random"
TUNER_MODELBASED = "model_based"


@dataclasses.dataclass(init=False)
class AutotuningConfig(ConfigModel):
    enabled: bool = False
    fast: bool = True                      # fast mode: micro-batch only, fixed policies
    metric: str = METRIC_THROUGHPUT        # throughput | latency
    tuner_type: str = TUNER_GRIDSEARCH     # gridsearch | random | model_based
    # model_based: how many spread-out survivors seed the cost model before
    # prediction starts steering the measure order
    tuner_num_seed_trials: int = 3
    # trial cap for random / model_based tuners; gridsearch measures the full
    # cross product (a stage-major cut would drop whole ZeRO stages), early
    # stopping bounding its tail
    tuner_num_trials: int = 50
    tuner_early_stopping: int = 5
    results_dir: str = "autotuning_results"
    overwrite: bool = True

    # measurement window (reference start/end_profile_step)
    start_profile_step: int = 2
    end_profile_step: int = 6

    # search-space bounds
    min_train_micro_batch_size_per_gpu: int = 1
    max_train_micro_batch_size_per_gpu: Optional[int] = None  # None = probe upward
    zero_stages: List[int] = dataclasses.field(default_factory=lambda: [1, 2, 3])
    remat_policies: List[str] = dataclasses.field(
        default_factory=lambda: ["none", "dots", "selective", "full"])
    loss_chunks: List[int] = dataclasses.field(default_factory=lambda: [0, 2048])
    # the JAX package's layer-scan and flash-block axes, parsed for parity
    # and refused at anything but their defaults: the port runs its layers
    # in a Python loop (no scan to toggle) and kernel A at the tiles it was
    # built with (no block override), so neither has a setting to search
    scan_layers_options: List = dataclasses.field(default_factory=lambda: [None])
    attn_blocks: List[int] = dataclasses.field(default_factory=lambda: [0])

    # per-device memory budget for the prune; None = the card's total memory
    hbm_budget_bytes: Optional[int] = None
    # fraction of the budget usable by one step's live bytes (leaves room
    # for fragmentation and runtime overheads)
    hbm_fraction: float = 0.9

    def __init__(self, **data):
        super().__init__(**data)
        if self.metric not in (METRIC_THROUGHPUT, METRIC_LATENCY):
            raise ValueError(f"autotuning.metric={self.metric!r} (expected throughput|latency)")
        if self.tuner_type not in (TUNER_GRIDSEARCH, TUNER_RANDOM, TUNER_MODELBASED):
            raise ValueError(f"autotuning.tuner_type={self.tuner_type!r} "
                             "(expected gridsearch|random|model_based)")
        for name, least in (("tuner_num_seed_trials", 1), ("tuner_num_trials", 1),
                            ("tuner_early_stopping", 1), ("start_profile_step", 0),
                            ("end_profile_step", 1),
                            ("min_train_micro_batch_size_per_gpu", 1)):
            if getattr(self, name) < least:
                raise ValueError(f"autotuning.{name} must be >= {least}, "
                                 f"got {getattr(self, name)}")
        for name, default in (("scan_layers_options", [None]), ("attn_blocks", [0])):
            if list(getattr(self, name)) != default:
                not_ported(f"autotuning.{name}={getattr(self, name)!r}",
                           "queue 3: the autotuner's scan and block axes")
        if not 0 < self.hbm_fraction <= 1:
            raise ValueError(f"autotuning.hbm_fraction must be in (0, 1], "
                             f"got {self.hbm_fraction}")
