"""Loss scaling for fp16 training (counterpart of
``deepspeed_tpu/runtime/loss_scaler.py``): the static and dynamic loss-scale
state and its grow / backoff / hysteresis transition (``update`` :85), and
``has_overflow``.

The JAX package keeps the state on the device and decides the skip inside
the compiled step; the port keeps it on the host as plain numbers, so an
fp16 step reads one overflow flag from the device (bf16 and fp32 training
never do).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    loss_scale: float
    good_steps: int          # consecutive non-overflow steps
    hysteresis: int          # remaining tolerated overflows
    init_scale: float = 2.0**16
    scale_window: int = 1000
    min_scale: float = 1.0
    delayed_shift: int = 2
    scale_factor: float = 2.0
    dynamic: bool = True

    def _replace(self, **kwargs) -> "LossScaleState":
        return dataclasses.replace(self, **kwargs)


def make_loss_scale_state(init_scale: float = 2.0**16, scale_window: int = 1000,
                          min_scale: float = 1.0, delayed_shift: int = 2,
                          scale_factor: float = 2.0, dynamic: bool = True) -> LossScaleState:
    return LossScaleState(loss_scale=float(init_scale), good_steps=0, hysteresis=int(delayed_shift),
                          init_scale=init_scale, scale_window=scale_window, min_scale=min_scale,
                          delayed_shift=delayed_shift, scale_factor=scale_factor, dynamic=dynamic)


def has_overflow(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: True if the fp32 sum of |g| over every grad is not
    finite (any NaN / Inf element, or a sum that overflows), as the JAX
    package's single fused reduction. ``grads`` may be a generator."""
    sums = [g.float().abs().sum() for g in grads]
    if not sums:
        return torch.tensor(False)
    return ~torch.isfinite(torch.stack(sums).sum())


def update(state: LossScaleState, overflow: bool) -> LossScaleState:
    """Next scaler state after a step that did/didn't overflow."""
    if not state.dynamic:
        return state
    overflow = bool(overflow)
    new_hyst = max(state.hysteresis - 1, 0) if overflow else state.hysteresis
    backoff = overflow and state.hysteresis <= 1
    good = 0 if overflow else state.good_steps + 1
    grow = (not overflow) and good >= state.scale_window
    if backoff:
        new_scale = max(state.loss_scale / state.scale_factor, state.min_scale)
    elif grow:
        new_scale = state.loss_scale * state.scale_factor
    else:
        new_scale = state.loss_scale
    if grow:
        good = 0
    if not overflow and state.good_steps > 0:
        new_hyst = state.delayed_shift
    return state._replace(loss_scale=new_scale, good_steps=good, hysteresis=new_hyst)
