"""Compression scheduler, the counterpart of
``deepspeed_tpu/compression/scheduler.py`` (reference
``compression/scheduler.py``): activates each technique group once training
passes its ``schedule_offset`` (and deactivates after
``schedule_offset_end`` when set). The user steps it after every global
step (reference hook ``runtime/engine.py:1668,1974``).
"""

from __future__ import annotations

from typing import Dict

from deepspeed_tpu_torch.compression.compress import CompressedModel
from deepspeed_tpu_torch.utils.logging import logger


class CompressionScheduler:

    def __init__(self, model: CompressedModel):
        if not isinstance(model, CompressedModel):
            raise TypeError("CompressionScheduler requires an init_compression()-wrapped model")
        self.model = model
        self.training_steps = 0
        self._announced: Dict[int, bool] = {}
        self._refresh()

    def _refresh(self) -> None:
        for rule in self.model.rules:
            offset = int(rule.params.get("schedule_offset", 0))
            end = rule.params.get("schedule_offset_end")
            active = self.training_steps >= offset and (
                end is None or self.training_steps <= int(end))
            self.model.set_active(rule, active)
            if active and not self._announced.get(id(rule)):
                logger.info(f"compression group '{rule.name}' ({rule.technique}) "
                            f"activated at step {self.training_steps}")
                self._announced[id(rule)] = True

    def step(self, step_zero_check: bool = False) -> None:
        if not step_zero_check:
            self.training_steps += 1
        self._refresh()

    def state_dict(self) -> Dict:
        return {"training_steps": self.training_steps}

    def load_state_dict(self, sd: Dict) -> None:
        self.training_steps = sd["training_steps"]
        self._refresh()
