"""Random-LTD schedule (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_routing/scheduler.py``; reference
``runtime/data_pipeline/data_routing/scheduler.py``): how many tokens each
random-LTD layer keeps at a given global step, ramping linearly from
``start_ratio``·S to the full sequence over ``total_layer_tokens`` steps.
"""

from __future__ import annotations

from typing import Dict


class RandomLTDScheduler:

    def __init__(self, config: Dict):
        # schema mirrors the reference's random_ltd config block
        self.total_layers = config.get("random_ltd_layer_num", 0)
        self.layer_ids = config.get("random_ltd_layer_id", [])
        self.global_batch_size = config.get("global_batch_size", 1)
        sched = config.get("random_ltd_schedule", config.get("schedule", {}))
        self.min_value = sched.get("min_value", 128)
        self.max_value = sched.get("max_value", 1024)
        self.schedule_type = sched.get("schedule_type", "fixed_linear")
        schedule_config = sched.get("schedule_config", {})
        self.total_steps = schedule_config.get("total_curriculum_step",
                                               schedule_config.get("require_steps", 1000))
        self.seq_step = schedule_config.get("seq_per_step", 8)
        self.current_seq = self.min_value
        self.global_steps = 0

    def get_current_seq(self) -> int:
        return self.current_seq

    def update_seq(self, global_steps: int) -> int:
        self.global_steps = global_steps
        if self.current_seq < self.max_value:
            frac = min(1.0, global_steps / max(1, self.total_steps))
            raw = self.min_value + (self.max_value - self.min_value) * frac
            q = int(raw // self.seq_step * self.seq_step)
            self.current_seq = max(self.min_value, min(q, self.max_value))
        return self.current_seq

    def state_dict(self) -> Dict:
        return {"current_seq": self.current_seq, "global_steps": self.global_steps}

    def load_state_dict(self, sd: Dict) -> None:
        self.current_seq = sd["current_seq"]
        self.global_steps = sd["global_steps"]
