"""DeepSpeedCPUAdagrad: host-memory Adagrad for ZeRO-Offload, the
counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adagrad import cpu_adagrad_binding


class DeepSpeedCPUAdagrad:
    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.step_count = 0
        self._h: Dict[str, torch.Tensor] = {}

    def register(self, key: str, numel: int) -> None:
        if key not in self._h:
            self._h[key] = torch.zeros(numel, dtype=torch.float32)
        elif self._h[key].numel() != numel:
            raise ValueError(f"partition '{key}' re-registered with {numel} elements "
                             f"but optimizer state holds {self._h[key].numel()}; "
                             "partitions are fixed-size once registered")

    def begin_step(self, lr: Optional[float] = None) -> None:
        self.step_count += 1
        if lr is not None:
            self.lr = lr

    def step(self, key: str, params, grads, param_out_bf16=None) -> None:
        self.register(key, params.numel() if isinstance(params, torch.Tensor) else params.size)
        cpu_adagrad_binding.adagrad_step(params, grads, self._h[key], lr=self.lr,
                                         eps=self.eps, weight_decay=self.weight_decay,
                                         param_out_bf16=param_out_bf16)

    def state_dict(self) -> dict:
        return {"step": self.step_count, "lr": self.lr,
                "exp_avg_sq": {k: v.numpy().copy() for k, v in self._h.items()}}

    def load_state_dict(self, sd: dict) -> None:
        self.step_count = int(sd["step"])
        self.lr = float(sd.get("lr", self.lr))
        self._h = {k: torch.from_numpy(np.array(v, np.float32).ravel())
                   for k, v in sd["exp_avg_sq"].items()}
