"""Structured per-step tracing, the profile window and the build watchdog
(counterpart of ``deepspeed_tpu/monitor/trace.py``).

- :class:`StepTracer` — host-side spans (``with tracer.span("fwd")``) that
  also push/pop the accelerator's range (``torch.cuda.nvtx`` on CUDA, a
  no-op on the CPU), exportable as chrome-trace JSON (Perfetto /
  ``chrome://tracing``).
- :class:`ProfileWindow` — a bounded ``torch.profiler`` capture over a
  window of train steps, written as a chrome trace into its directory.
- :class:`CompileWatchdog` — the port compiles nothing per call: the
  counterpart of a JAX compile is a kernel library's nvcc build at first
  use (``ops/kernels/build.py``), recorded here with its name and wall
  seconds. ``watch(fn, name)`` is the identity. ``summary()`` keeps the JAX
  keys ``total``, ``by_fn`` and ``events``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.accelerator.real_accelerator import default_accelerator
from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry, get_registry
from deepspeed_tpu_torch.utils.logging import logger


# ------------------------------------------------------------------ #
# step tracer


class StepTracer:
    """Span recorder: chrome-trace "complete" (ph=X) events, bounded."""

    #: chrome-trace pid of the host-span track group (the serving trace
    #: renderer uses 1/2, so merged host+serving documents never collide)
    PID = 0

    def __init__(self, max_events: int = 100_000, use_accelerator: bool = True):
        self.max_events = max_events
        self.use_accelerator = use_accelerator
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._dropped = 0
        self._warned_drop = False
        self._t0 = time.perf_counter()

    @property
    def dropped(self) -> int:
        """Spans discarded at ``max_events`` — nonzero means every export
        from this tracer is TRUNCATED, not complete."""
        with self._lock:
            return self._dropped

    @contextmanager
    def span(self, name: str, **args):
        """Host span around the with-block, mirrored onto the device
        profiler timeline through ``range_push``/``range_pop``."""
        acc = default_accelerator() if self.use_accelerator else None
        if acc is not None:
            acc.range_push(name)
        start = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - start
            if acc is not None:
                acc.range_pop()
            self.add_event(name, start, dur, args or None)

    def add_event(self, name: str, start_s: float, dur_s: float,
                  args: Optional[Dict] = None) -> None:
        tid = threading.get_ident() % 2**31
        ev = {"name": name, "ph": "X", "pid": self.PID, "tid": tid,
              "ts": (start_s - self._t0) * 1e6, "dur": dur_s * 1e6}
        if args:
            ev["args"] = {k: str(v) for k, v in args.items()}
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if len(self._events) >= self.max_events:
                self._dropped += 1
                warn_now = not self._warned_drop
                self._warned_drop = True
                try:
                    get_registry().counter(
                        "trace/dropped_events",
                        "StepTracer spans discarded at max_events — a "
                        "nonzero value means exported chrome traces are "
                        "truncated, not complete").inc()
                except Exception:
                    pass
                if warn_now:
                    logger.warning(
                        f"StepTracer hit max_events={self.max_events}; "
                        "further spans are dropped (trace/dropped_events "
                        "counts them) — exported traces are truncated")
                return
            self._events.append(ev)

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._thread_names.clear()
            self._dropped = 0
            self._warned_drop = False

    def export_chrome_trace(self, path: str) -> str:
        """Write the recorded spans as chrome-trace JSON; returns path."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            names = dict(self._thread_names)
        meta: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": self.PID,
             "args": {"name": "deepspeed_tpu host"}}]
        for tid in sorted(names):
            meta.append({"ph": "M", "name": "thread_name", "pid": self.PID,
                         "tid": tid, "args": {"name": names[tid]}})
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if dropped:
            doc["otherData"] = {"dropped_events": dropped}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


# ------------------------------------------------------------------ #
# on-demand device profiling: a torch.profiler capture window


class ProfileWindow:
    """Bounded ``torch.profiler`` capture armed by config
    (``telemetry.profile: {start_step, num_steps, dir}``) or
    programmatically (``engine.profile(steps=N)``): the engine calls
    :meth:`tick` once per ``train_batch`` (one None check when nothing is
    armed) and the window starts/stops the profiler around the requested
    steps, writing ``trace_<n>.json`` (chrome trace) into its directory.
    Steps are counted as tick calls in this process. While capturing,
    :meth:`annotate` pushes the accelerator range under the
    :class:`StepTracer` span names."""

    def __init__(self, log_dir: str = "ds_profile", start_step: int = 0,
                 num_steps: int = 0):
        self.log_dir = log_dir
        self._lock = threading.Lock()
        self._step = 0
        self._stop_at: Optional[int] = None
        self.active = False
        self.captures = 0
        self._prof = None
        self._dir = log_dir
        self._armed: Optional[Dict[str, Any]] = None
        if num_steps > 0:
            self._armed = {"start": max(int(start_step), 0),
                           "steps": int(num_steps), "dir": log_dir}

    def arm(self, steps: int, log_dir: Optional[str] = None,
            start_step: Optional[int] = None) -> None:
        """Request a capture of ``steps`` train steps, starting at the next
        tick (or at absolute tick ``start_step``)."""
        if steps < 1:
            raise ValueError("profile steps must be >= 1")
        with self._lock:
            if self.active:
                raise RuntimeError("a profile capture is already running")
            self._armed = {"start": (self._step if start_step is None
                                     else int(start_step)),
                           "steps": int(steps),
                           "dir": log_dir or self.log_dir}

    def tick(self) -> None:
        """One train-step boundary: start the capture when the armed window
        begins, stop it when the window has covered its steps."""
        with self._lock:
            step = self._step
            self._step += 1
            if self.active:
                if step >= self._stop_at:
                    self._stop()
                return
            armed = self._armed
            if armed is None or step < armed["start"]:
                return
            self._armed = None
            self._stop_at = step + armed["steps"]
            try:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            except Exception as e:
                logger.warning(f"profile: start failed ({e}); capture window dropped")
                self._stop_at = None
                return
            self._prof = prof
            self._dir = armed["dir"]
            self.active = True
            logger.info(f"profile: capturing {armed['steps']} step(s) to {armed['dir']}")

    def _stop(self) -> None:
        try:
            self._prof.__exit__(None, None, None)
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(self._dir, f"trace_{self.captures}.json")
            self._prof.export_chrome_trace(path)
            self.captures += 1
            logger.info(f"profile: capture complete ({path})")
        except Exception as e:
            logger.warning(f"profile: stop failed ({e})")
        self._prof = None
        self.active = False
        self._stop_at = None

    def stop(self) -> None:
        """Force-stop an active capture (engine teardown)."""
        with self._lock:
            if self.active:
                self._stop()

    @contextmanager
    def annotate(self, name: str):
        """Accelerator range around the with-block while a capture is
        active (no-op otherwise)."""
        if not self.active:
            yield
            return
        acc = default_accelerator()
        acc.range_push(name)
        try:
            yield
        finally:
            acc.range_pop()


# ------------------------------------------------------------------ #
# build watchdog


class CompileWatchdog:
    """Records kernel-library builds (``ops/kernels/build.py`` calls
    :meth:`record_build` for each library it compiles): a count and the
    wall seconds by library, under the JAX watchdog's series and summary
    keys. A library builds once per source (its file name hashes it), so
    the JAX watchdog's recompilation-storm warning has nothing to watch."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.events: List[Dict[str, Any]] = []

    def watch(self, fn, name: str):
        """The identity: nothing compiles per call in the port."""
        return fn

    def record_build(self, name: str, wall_s: float) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
            self.events.append({"name": name, "wall_time_s": wall_s, "shapes": "nvcc",
                                "count": self._counts[name]})
        self.registry.counter("compile/count", "kernel-library builds (nvcc) per library",
                              labelnames=("fn",)).labels(fn=name).inc()
        self.registry.histogram("compile/time_ms", "build wall time",
                                labelnames=("fn",)).labels(fn=name).observe(wall_s * 1e3)

    def compile_count(self, name: Optional[str] = None) -> int:
        with self._lock:
            if name is not None:
                return self._counts.get(name, 0)
            return sum(self._counts.values())

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"total": sum(self._counts.values()),
                    "by_fn": dict(self._counts),
                    "events": list(self.events[-50:])}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self.events.clear()


# ------------------------------------------------------------------ #
# process-global instances

_tracer: Optional[StepTracer] = None
_watchdog: Optional[CompileWatchdog] = None
_lock = threading.Lock()


def get_tracer() -> StepTracer:
    global _tracer
    if _tracer is None:
        with _lock:
            if _tracer is None:
                _tracer = StepTracer()
    return _tracer


def get_compile_watchdog() -> CompileWatchdog:
    global _watchdog
    if _watchdog is None:
        with _lock:
            if _watchdog is None:
                _watchdog = CompileWatchdog()
    return _watchdog
