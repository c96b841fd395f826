"""Learning-rate schedules (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py`` :35-209): ``LRRangeTest``,
``OneCycle``, ``WarmupLR`` and ``WarmupDecayLR`` with the same knob names.

Each schedule is a pure function ``step -> lr`` (the engine evaluates it on
the host before each update) with a stateful wrapper keeping the reference's
``step()`` / ``get_lr()`` / ``state_dict()`` surface. The JAX functions run
in fp32 inside the compiled step; these run in Python floats, which differ
from them by at most a rounding of the fp32 result.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def lr_range_test_fn(lr_range_test_min_lr: float = 1e-3,
                     lr_range_test_step_size: int = 2000,
                     lr_range_test_step_rate: float = 1.0,
                     lr_range_test_staircase: bool = False) -> Callable:
    """Increasing-LR sweep for finding stable LR ranges."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


def one_cycle_fn(cycle_min_lr: float,
                 cycle_max_lr: float,
                 decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0) -> Callable:
    """1-cycle policy: ramp min->max over the first phase, back down over the
    second, then optional decay below min."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        up_frac = _clip(step / cycle_first_step_size, 0.0, 1.0)
        down_frac = _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
        if step <= cycle_first_step_size:
            cycle_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up_frac
        else:
            cycle_lr = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac
        if step <= total_cycle:
            return cycle_lr
        if decay_step_size > 0:
            decay_intervals = math.floor((step - total_cycle) / decay_step_size)
            return cycle_min_lr / (1.0 + decay_lr_rate * max(decay_intervals, 0.0))
        return cycle_min_lr

    return schedule


def warmup_lr_fn(warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE) -> Callable:
    """Warm up from min to max then hold."""

    def schedule(step):
        step_f = step * 1.0
        if warmup_type == WARMUP_LOG_RATE:
            # log-shaped ramp: lr scales with log(step)/log(warmup_steps)
            gamma = math.log1p(step_f) / math.log1p(warmup_num_steps) if step_f > 0 else 0.0
            gamma = _clip(gamma, 0.0, 1.0)
        else:
            gamma = _clip(step_f / warmup_num_steps, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr_fn(total_num_steps: int,
                       warmup_min_lr: float = 0.0,
                       warmup_max_lr: float = 0.001,
                       warmup_num_steps: int = 1000,
                       warmup_type: str = WARMUP_LOG_RATE) -> Callable:
    """Warm up then linearly decay to zero by ``total_num_steps``."""
    warm = warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        if step <= warmup_num_steps:
            return warm(step)
        decay = (total_num_steps - step) * 1.0 / max(1, total_num_steps - warmup_num_steps)
        return warmup_max_lr * _clip(decay, 0.0, 1.0)

    return schedule


SCHEDULE_FNS = {
    LR_RANGE_TEST: lr_range_test_fn,
    ONE_CYCLE: one_cycle_fn,
    WARMUP_LR: warmup_lr_fn,
    WARMUP_DECAY_LR: warmup_decay_lr_fn,
}


def get_lr_schedule_fn(name: str, params: Dict[str, Any]) -> Callable:
    if name not in SCHEDULE_FNS:
        raise ValueError(f"Unknown LR schedule {name}; valid: {VALID_LR_SCHEDULES}")
    # drop reference-only knobs that do not affect the lr curve
    params = {k: v for k, v in params.items() if k not in ("cycle_momentum", "cycle_min_mom", "cycle_max_mom",
                                                           "decay_mom_rate", "last_batch_iteration")}
    return SCHEDULE_FNS[name](**params)


class _ScheduleBase:
    """Stateful wrapper over a pure schedule fn; mirrors the reference's
    scheduler objects (step/get_lr/state_dict)."""

    def __init__(self, schedule_fn: Callable, last_batch_iteration: int = -1):
        self._fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [float(self._fn(max(0, self.last_batch_iteration)))]

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def state_dict(self) -> Dict:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]

    @property
    def schedule_fn(self) -> Callable:
        return self._fn


class LRRangeTest(_ScheduleBase):

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(
            lr_range_test_fn(lr_range_test_min_lr, lr_range_test_step_size, lr_range_test_step_rate,
                             lr_range_test_staircase), last_batch_iteration)


class OneCycle(_ScheduleBase):

    def __init__(self, optimizer=None, cycle_min_lr=0.0, cycle_max_lr=0.001, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0, last_batch_iteration=-1, **_momentum_unused):
        super().__init__(
            one_cycle_fn(cycle_min_lr, cycle_max_lr, decay_lr_rate, cycle_first_step_size, cycle_second_step_size,
                         cycle_first_stair_count, cycle_second_stair_count, decay_step_size), last_batch_iteration)


class WarmupLR(_ScheduleBase):

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        super().__init__(
            warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type), last_batch_iteration)


class WarmupDecayLR(_ScheduleBase):

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        super().__init__(
            warmup_decay_lr_fn(total_num_steps, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type),
            last_batch_iteration)


def add_tuning_arguments(parser):
    """Add the LR-schedule tuning CLI group (the JAX package's
    ``add_tuning_arguments``). Defaults are ``None`` so only what the user
    passed overrides the config."""
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help=f"LR schedule: one of {VALID_LR_SCHEDULES}")
    # LRRangeTest
    group.add_argument("--lr_range_test_min_lr", type=float, default=None)
    group.add_argument("--lr_range_test_step_size", type=int, default=None)
    group.add_argument("--lr_range_test_step_rate", type=float, default=None)
    # type=bool would turn ANY non-empty string (incl. "false") into True
    group.add_argument("--lr_range_test_staircase", default=None,
                       type=lambda s: s.lower() in ("1", "true", "yes"))
    # OneCycle
    group.add_argument("--cycle_first_step_size", type=int, default=None)
    group.add_argument("--cycle_first_stair_count", type=int, default=None)
    group.add_argument("--cycle_second_step_size", type=int, default=None)
    group.add_argument("--cycle_second_stair_count", type=int, default=None)
    group.add_argument("--decay_step_size", type=int, default=None)
    group.add_argument("--cycle_min_lr", type=float, default=None)
    group.add_argument("--cycle_max_lr", type=float, default=None)
    group.add_argument("--decay_lr_rate", type=float, default=None)
    # Warmup(Decay)LR
    group.add_argument("--warmup_min_lr", type=float, default=None)
    group.add_argument("--warmup_max_lr", type=float, default=None)
    group.add_argument("--warmup_num_steps", type=int, default=None)
    group.add_argument("--warmup_type", type=str, default=None)
    group.add_argument("--total_num_steps", type=int, default=None)
    return parser
