"""The comms-logger section of a training config (counterpart of
``deepspeed_tpu/comm/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import List

from deepspeed_tpu_torch.config.config_utils import ConfigModel

COMMS_LOGGER = "comms_logger"


@dataclasses.dataclass(init=False)
class CommsLoggerConfig(ConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = dataclasses.field(default_factory=list)


class DeepSpeedCommsConfig:

    def __init__(self, ds_config: dict):
        self.comms_logger_enabled = COMMS_LOGGER in ds_config
        if self.comms_logger_enabled:
            self.comms_logger = CommsLoggerConfig(**ds_config[COMMS_LOGGER])
        else:
            self.comms_logger = CommsLoggerConfig()
