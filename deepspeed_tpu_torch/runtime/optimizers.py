"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

The engine-built optimizers of the training slice, ``adam``, ``adamw`` and
``fusedadam``, keep the JAX engine's update: ``master <- master - lr * u``
with ``u`` the positive descent direction and ``lr`` the engine's scheduled
lr (``runtime/engine.py _apply_update``). The three share one Adam
(``optax.scale_by_adam`` and the fused kernel compute the same function),
which runs kernel E on the card (the port of the TPU's Pallas
``_adam_kernel``) with the subtraction fused in (``emit="param"``, the same
two fp32 roundings as ``master - lr * u``); they differ only in how weight
decay applies. The rest of the JAX factory raises ``NotImplementedError``
naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.config import core as config_core
from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fused

_NOT_PORTED = {
    config_core.FUSED_LAMB_OPTIMIZER: "queue 2: K7 fused LAMB",
    config_core.LAMB_OPTIMIZER: "queue 1: training step (lamb, sgd, lion, adagrad)",
    config_core.SGD_OPTIMIZER: "queue 1: training step (lamb, sgd, lion, adagrad)",
    config_core.ADAGRAD_OPTIMIZER: "queue 1: training step (lamb, sgd, lion, adagrad)",
    config_core.LION_OPTIMIZER: "queue 1: training step (lamb, sgd, lion, adagrad)",
    config_core.ONEBIT_ADAM_OPTIMIZER: "queue 1: runtime/fp16/onebit/",
    config_core.ZERO_ONE_ADAM_OPTIMIZER: "queue 1: runtime/fp16/onebit/",
    config_core.ONEBIT_LAMB_OPTIMIZER: "queue 1: runtime/fp16/onebit/",
}


@dataclasses.dataclass
class AdamState:
    """The optimizer state: the update count and fp32 first / second
    moments per parameter leaf (the fields of optax's ``ScaleByAdamState``
    and the JAX package's ``FusedAdamState``)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """Adam / AdamW applied leaf by leaf through ``fused_adam_step`` (kernel
    E on CUDA tensors, its plain version on the CPU). ``adam_w_mode``
    decouples weight decay (``u + wd * p``); otherwise it is L2 folded into
    the gradient first."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)

    def init(self, named_params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(count=0, mu={n: zeros(p) for n, p in named_params.items()},
                         nu={n: zeros(p) for n, p in named_params.items()})

    def leaf_update(self, state: AdamState, name: str, grad: torch.Tensor,
                    param: torch.Tensor, lr: float) -> None:
        """``param <- param - lr * u`` in place (``param`` contiguous; the
        master, or the fp32 param) for one leaf at update count
        ``state.count`` (1-based, already advanced by the caller); the
        leaf's moments are updated in place too."""
        flat = param.view(-1)
        fused.fused_adam_step(flat, grad.reshape(-1), state.mu[name].view(-1),
                              state.nu[name].view(-1), step=state.count, lr=lr, b1=self.b1,
                              b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
                              adam_w_mode=self.adam_w_mode, emit="param", out=flat)


def _adam_args(params: Dict[str, Any]) -> Dict[str, Any]:
    betas = params.get("betas", (0.9, 0.999))
    return dict(b1=betas[0], b2=betas[1], eps=params.get("eps", 1e-8),
                weight_decay=params.get("weight_decay", 0.0))


def build_optimizer(name: Optional[str], params: Optional[Dict[str, Any]] = None) -> Adam:
    """The engine-built optimizer for config ``optimizer.type`` ``name``
    (default adamw) with ``optimizer.params`` (``lr`` is the engine's)."""
    params = dict(params or {})
    name = (name or config_core.ADAMW_OPTIMIZER).lower()
    if name == config_core.ADAM_OPTIMIZER:
        # reference Adam applies L2-style weight decay unless adam_w_mode
        return Adam(adam_w_mode=params.get("adam_w_mode", False), **_adam_args(params))
    if name == config_core.ADAMW_OPTIMIZER:
        return Adam(adam_w_mode=True, **_adam_args(params))
    if name == config_core.FUSED_ADAM_OPTIMIZER:
        return Adam(adam_w_mode=params.get("adam_w_mode", True), **_adam_args(params))
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name} is not ported to deepspeed_tpu_torch yet "
                                  f"(ROADMAP.md {_NOT_PORTED[name]})")
    raise ValueError(f"Unknown optimizer: {name}")
