"""fp16 / bf16 / amp sub-configs (counterpart of
``deepspeed_tpu/config/precision.py``): the same fields and defaults, as
dataclasses on :class:`~deepspeed_tpu_torch.config.config_utils.ConfigModel`
(no pydantic)."""

from __future__ import annotations

import dataclasses

from deepspeed_tpu_torch.config.config_utils import ConfigModel


@dataclasses.dataclass(init=False)
class FP16Config(ConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic loss scaling
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@dataclasses.dataclass(init=False)
class BF16Config(ConfigModel):
    enabled: bool = False
    accumulate_grads_in_fp32: bool = True


@dataclasses.dataclass(init=False)
class AMPConfig(ConfigModel):
    enabled: bool = False
    opt_level: str = "O1"
