"""Curriculum learning scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``, the
reference's ``runtime/data_pipeline/curriculum_scheduler.py``).

Maps global step → difficulty (e.g. sequence length) with the reference's
schedule types: ``fixed_linear``, ``fixed_root``, ``fixed_discrete``, and
``custom`` (user callable). Difficulties advance in ``difficulty_step``
quanta, rounded up (:meth:`CurriculumScheduler._quantize`); the reference
recommends multiples of 8 for tensor cores. A seqlen that is not a multiple
of 64 runs the attention kernels on a ragged last tile.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:

    def __init__(self, config: Dict):
        self.state: Dict = {}
        for key in ("curriculum_type", "min_difficulty", "max_difficulty", "schedule_type"):
            if key not in config and config.get("schedule_type") != CUSTOM:
                if key == "curriculum_type" and "curriculum_type" not in config:
                    config["curriculum_type"] = "seqlen"
                elif key not in config:
                    raise ValueError(f"Curriculum learning requires the config '{key}'")
        if config.get("schedule_type") == CUSTOM:
            # custom schedules may omit the bounds (the callable is in charge)
            self.state["min_difficulty"] = config.get("min_difficulty", 0)
            self.state["max_difficulty"] = config.get("max_difficulty", float("inf"))
        else:
            self.state["min_difficulty"] = config["min_difficulty"]
            self.state["max_difficulty"] = config["max_difficulty"]
        self.state["current_difficulty"] = self.state["min_difficulty"]
        self.state["schedule_type"] = config["schedule_type"]
        self.custom_get_difficulty: Optional[Callable[[int], int]] = None

        schedule_config = config.get("schedule_config", {})
        if self.state["schedule_type"] in (FIXED_LINEAR, FIXED_ROOT):
            for key in ("total_curriculum_step", "difficulty_step"):
                if key not in schedule_config:
                    raise ValueError(f"schedule_config requires '{key}'")
            if schedule_config["difficulty_step"] % 8 != 0:
                from deepspeed_tpu_torch.utils.logging import logger
                logger.warning("difficulty_step not a multiple of 8: curriculum seqlens "
                               "will not be tensor-core tile aligned")
            if self.state["schedule_type"] == FIXED_ROOT and "root_degree" not in schedule_config:
                raise ValueError("fixed_root schedule requires 'root_degree'")
        elif self.state["schedule_type"] == FIXED_DISCRETE:
            for key in ("difficulty", "max_step"):
                if key not in schedule_config:
                    raise ValueError(f"schedule_config requires '{key}'")
            if len(schedule_config["max_step"]) != len(schedule_config["difficulty"]) - 1:
                raise ValueError("fixed_discrete needs len(max_step) == len(difficulty) - 1")
        elif self.state["schedule_type"] != CUSTOM:
            raise ValueError(f"Unknown curriculum schedule {self.state['schedule_type']}")
        self.state["schedule"] = schedule_config

    # ------------------------------------------------------------------ #

    def get_current_difficulty(self) -> int:
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty: int) -> None:
        self.state["current_difficulty"] = difficulty

    def set_custom_get_difficulty(self, fn: Callable[[int], int]) -> None:
        self.custom_get_difficulty = fn

    def get_state(self) -> Dict:
        return self.state

    def set_state(self, state: Dict) -> None:
        self.state = state

    # ------------------------------------------------------------------ #

    def _fixed_linear(self, global_steps: int) -> int:
        s = self.state["schedule"]
        span = self.state["max_difficulty"] - self.state["min_difficulty"]
        next_diff = self.state["min_difficulty"] + span * min(
            1.0, global_steps / s["total_curriculum_step"])
        return self._quantize(next_diff, s["difficulty_step"])

    def _fixed_root(self, global_steps: int) -> int:
        s = self.state["schedule"]
        frac = min(1.0, global_steps / s["total_curriculum_step"])
        span = self.state["max_difficulty"] - self.state["min_difficulty"]
        next_diff = self.state["min_difficulty"] + span * (frac ** (1.0 / s["root_degree"]))
        return self._quantize(next_diff, s["difficulty_step"])

    def _fixed_discrete(self, global_steps: int) -> int:
        s = self.state["schedule"]
        for i, boundary in enumerate(s["max_step"]):
            if global_steps <= boundary:
                return s["difficulty"][i]
        return s["difficulty"][-1]

    def _quantize(self, difficulty: float, step: int) -> int:
        q = int((difficulty + step - 1) // step * step) if step > 1 else int(math.ceil(difficulty))
        return min(q, self.state["max_difficulty"])

    def get_difficulty(self, global_steps: int) -> int:
        kind = self.state["schedule_type"]
        if kind == FIXED_LINEAR:
            return self._fixed_linear(global_steps)
        if kind == FIXED_ROOT:
            return self._fixed_root(global_steps)
        if kind == FIXED_DISCRETE:
            return self._fixed_discrete(global_steps)
        if kind == CUSTOM:
            if self.custom_get_difficulty is None:
                raise ValueError("custom schedule requires set_custom_get_difficulty()")
            return self.custom_get_difficulty(global_steps)
        raise ValueError(f"Unknown schedule {kind}")

    def update_difficulty(self, global_steps: int) -> int:
        if self.state["current_difficulty"] < self.state["max_difficulty"]:
            self.state["current_difficulty"] = self.get_difficulty(global_steps)
        return self.state["current_difficulty"]
