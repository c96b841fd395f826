"""Autotuning: search ZeRO stage x micro-batch x remat policy x loss chunk
(counterpart of ``deepspeed_tpu/autotuning/``; reference
``deepspeed/autotuning/autotuner.py``): prune by an estimate of each
candidate's live bytes against the card's memory, measure the survivors
through ``initialize``, write ``ds_config_optimal.json``."""

from deepspeed_tpu_torch.autotuning.autotuner import Autotuner, apply_optimal, autotune
from deepspeed_tpu_torch.autotuning.config import AutotuningConfig

__all__ = ["Autotuner", "AutotuningConfig", "apply_optimal", "autotune"]
