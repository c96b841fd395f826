"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``; reference ``deepspeed/utils/timer.py``).

``SynchronizedWallClockTimer`` brackets each interval with the
accelerator's ``synchronize`` (``torch.cuda.synchronize`` on CUDA, the
counterpart of the JAX ``effects_barrier``), so the host clock covers the
device work. ``ThroughputTimer`` counts samples/s; it syncs only on the
steps whose reading is reported (``steps_per_output``), so a run that does
not report (or a step that does not) pays no sync.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import log_dist


def _device_synchronize(accelerator=None) -> None:
    """Wait for the device's queued work so the host clock brackets it
    (through the accelerator, which counts the sync)."""
    if accelerator is None:
        from deepspeed_tpu_torch.accelerator.real_accelerator import default_accelerator
        accelerator = default_accelerator()
    accelerator.synchronize()


class Timer_:
    """A single named timer with start/stop/elapsed/mean."""

    def __init__(self, name: str, synchronize: bool = True, accelerator=None):
        self.name_ = name
        self.synchronize = synchronize
        self.accelerator = accelerator
        self.started_ = False
        self.start_time = 0.0
        self.elapsed_records: List[float] = []

    def start(self) -> None:
        assert not self.started_, f"{self.name_} timer has already been started"
        if self.synchronize:
            _device_synchronize(self.accelerator)
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, reset: bool = False, record: bool = True) -> None:
        assert self.started_, f"{self.name_} timer is not started"
        if self.synchronize:
            _device_synchronize(self.accelerator)
        elapsed = time.perf_counter() - self.start_time
        if record:
            self.elapsed_records.append(elapsed)
        self.started_ = False

    def _get_elapsed_msec(self) -> float:
        return sum(self.elapsed_records) * 1000.0

    def reset(self) -> None:
        self.started_ = False
        self.elapsed_records = []

    def elapsed(self, reset: bool = True) -> float:
        """Total elapsed time in milliseconds."""
        if self.started_:
            self.stop()
            self.start()
        total = self._get_elapsed_msec()
        if reset:
            self.elapsed_records = []
        return total

    def mean(self) -> float:
        """Mean of recorded intervals in milliseconds."""
        if not self.elapsed_records:
            return 0.0
        return self._get_elapsed_msec() / len(self.elapsed_records)


class SynchronizedWallClockTimer:
    """Group of named timers; mirrors the reference timer-group API."""

    FORWARD_MICRO_TIMER = "fwd_microstep"
    FORWARD_GLOBAL_TIMER = "fwd"
    BACKWARD_MICRO_TIMER = "bwd_microstep"
    BACKWARD_GLOBAL_TIMER = "bwd"
    BACKWARD_INNER_MICRO_TIMER = "bwd_inner_microstep"
    BACKWARD_INNER_GLOBAL_TIMER = "bwd_inner"
    BACKWARD_REDUCE_MICRO_TIMER = "bwd_allreduce_microstep"
    BACKWARD_REDUCE_GLOBAL_TIMER = "bwd_allreduce"
    STEP_MICRO_TIMER = "step_microstep"
    STEP_GLOBAL_TIMER = "step"

    def __init__(self, synchronize: bool = True, accelerator=None):
        self.timers: Dict[str, Timer_] = {}
        self.synchronize = synchronize
        self.accelerator = accelerator

    def __call__(self, name: str) -> Timer_:
        if name not in self.timers:
            self.timers[name] = Timer_(name, synchronize=self.synchronize,
                                       accelerator=self.accelerator)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True, memory_breakdown=None, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names: List[str], normalizer: float = 1.0, reset: bool = True) -> Dict[str, float]:
        assert normalizer > 0.0
        means = {}
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].mean() / normalizer
                means[name] = elapsed_time
                if reset:
                    self.timers[name].reset()
        return means


class NoopTimer:
    """Timer stand-in used when wall-clock breakdown is disabled."""

    class Timer:

        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0

        def mean(self):
            return 0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def has_timer(self, name):
        return True

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=None, ranks=None):
        ...

    def get_mean(self, names, normalizer=1.0, reset=True):
        return {}


class ThroughputTimer:
    """Samples/sec accounting across steps (reference timer.py:136). Only
    the steps that report (every ``steps_per_output``-th global step, from
    ``start_step`` on) are timed, each between two syncs; the average is
    over those steps."""

    def __init__(self,
                 batch_size: int,
                 start_step: int = 2,
                 steps_per_output: Optional[int] = None,
                 monitor_memory: bool = False,
                 logging_fn=None,
                 accelerator=None):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        # cumulative samples over the TIMED steps: batch_size can be
        # reassigned mid-run (elastic/curriculum ramp-up via
        # set_train_batch_size), so the average must sum what each step
        # actually carried, not multiply the current size by step count
        self.total_samples = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or log_dist
        self.accelerator = accelerator
        self.initialized = False

    def update_epoch_count(self) -> None:
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self) -> None:
        self.initialized = True

    def start(self) -> None:
        self._init_timer()
        self.started = True
        if (self.steps_per_output and self.global_step_count >= self.start_step
                and (self.global_step_count + 1) % self.steps_per_output == 0):
            # only pay the device syncs on a step whose reading is reported:
            # a per-step synchronize would serialize host dispatch against
            # the device for a number nobody reads
            _device_synchronize(self.accelerator)
            self.start_time = time.perf_counter()

    def stop(self, global_step: bool = False, report_speed: bool = True) -> None:
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            _device_synchronize(self.accelerator)
            self.end_time = time.perf_counter()
            duration = self.end_time - self.start_time
            self.start_time = 0.0
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step:
                self.total_samples += self.batch_size
                if report_speed and self.steps_per_output and (self.global_step_count % self.steps_per_output == 0):
                    self.logging(f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                                 f"global_step={self.global_step_count}, RunningAvgSamplesPerSec="
                                 f"{self.avg_samples_per_sec():.2f}, CurrSamplesPerSec="
                                 f"{self.batch_size / self.step_elapsed_time:.2f}")
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        """Running average over the timed window. Uses the CUMULATIVE
        sample count (one ``batch_size`` summed per timed step), so a
        ``set_train_batch_size`` ramp mid-run doesn't retroactively skew
        every earlier step's contribution."""
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            return self.total_samples / self.total_elapsed_time
        return -1.0


def trim_mean(data: List[float], trim_percent: float) -> float:
    """The mean of ``data`` without its tails (the JAX package's
    ``utils/timer.trim_mean``)."""
    if not 0.0 <= trim_percent <= 1.0:
        raise ValueError(f"trim_percent {trim_percent} outside [0, 1]")
    n = len(data)
    if n == 0:
        return 0.0
    data_sorted = sorted(data)
    trim_off = int(n * trim_percent)
    trimmed = data_sorted[trim_off:max(n - trim_off, trim_off + 1)]
    if not trimmed:
        trimmed = data_sorted
    return sum(trimmed) / len(trimmed)
