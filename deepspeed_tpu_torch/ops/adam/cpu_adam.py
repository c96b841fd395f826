"""DeepSpeedCPUAdam: host-memory Adam for ZeRO-Offload, the counterpart of
``deepspeed_tpu/ops/adam/cpu_adam.py``. The moments are fp32 CPU tensors,
one flat buffer a registered key (the offload optimizer's keys are the JAX
leaves), stepped in place by the host library's ``cpu_adam``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam import cpu_adam_binding


class DeepSpeedCPUAdam:
    """Flat-buffer Adam over host memory: the engine registers each flat
    fp32 master once by key, then calls :meth:`step` with that key and the
    key's gradient buffer, between :meth:`begin_step` calls that advance
    the shared timestep."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self._m: Dict[str, torch.Tensor] = {}
        self._v: Dict[str, torch.Tensor] = {}

    def register(self, key: str, numel: int) -> None:
        if key not in self._m:
            self._m[key] = torch.zeros(numel, dtype=torch.float32)
            self._v[key] = torch.zeros(numel, dtype=torch.float32)
        elif self._m[key].numel() != numel:
            raise ValueError(f"partition '{key}' re-registered with {numel} elements "
                             f"but optimizer state holds {self._m[key].numel()}; "
                             "partitions are fixed-size once registered")

    def begin_step(self, lr: Optional[float] = None) -> None:
        """Advance the shared timestep once an optimizer step (every key
        stepped until the next call shares its bias correction)."""
        self.step_count += 1
        if lr is not None:
            self.lr = lr

    def step(self, key: str, params, grads, param_out_bf16=None) -> None:
        """Fused in-place update of one registered flat buffer."""
        self.register(key, params.numel() if isinstance(params, torch.Tensor) else params.size)
        cpu_adam_binding.adam_step(
            params, grads, self._m[key], self._v[key], lr=self.lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, weight_decay=self.weight_decay,
            adamw_mode=self.adamw_mode, step=max(self.step_count, 1),
            param_out_bf16=param_out_bf16)

    # --- checkpoint support -------------------------------------------- #
    def state_dict(self) -> dict:
        return {"step": self.step_count, "lr": self.lr,
                "exp_avg": {k: v.numpy().copy() for k, v in self._m.items()},
                "exp_avg_sq": {k: v.numpy().copy() for k, v in self._v.items()}}

    def load_state_dict(self, sd: dict) -> None:
        self.step_count = int(sd["step"])
        self.lr = float(sd.get("lr", self.lr))
        self._m = {k: torch.from_numpy(np.array(v, np.float32).ravel())
                   for k, v in sd["exp_avg"].items()}
        self._v = {k: torch.from_numpy(np.array(v, np.float32).ravel())
                   for k, v in sd["exp_avg_sq"].items()}
