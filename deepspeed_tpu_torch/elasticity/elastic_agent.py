"""Elastic agent: worker monitoring and restart on failure or membership
change (counterpart of ``deepspeed_tpu/elasticity/elastic_agent.py``).

A self-contained supervisor of one node's ranks:

- spawn ``local_world_size`` worker processes with the launcher's rank
  environment (:func:`deepspeed_tpu_torch.launcher.launch.build_rank_env`),
  plus ``DSTPU_RESTART_COUNT`` and ``DSTPU_MAX_RESTARTS``;
- poll at ``monitor_interval``; all-zero exits -> SUCCEEDED;
- on any failure: stop the group, re-read the capacity (``capacity_fn``,
  the healthy local slots), take the largest world the elastic plan admits
  (:func:`deepspeed_tpu_torch.elasticity.compute_elastic_config`, so the
  batch size stays valid across scale events) and restart. A scale-down
  does not count against ``max_restarts`` (the failure is explained by lost
  capacity); every other restart does.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.launcher.launch import build_rank_env
from deepspeed_tpu_torch.utils.logging import logger


class WorkerState(str, Enum):
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"


@dataclasses.dataclass
class RunResult:
    state: WorkerState
    return_codes: List[int]
    restarts: int


@dataclasses.dataclass
class WorkerSpec:
    """What to run (reference ``WorkerSpec``): ``entrypoint`` argv; the
    agent appends nothing — rank identity arrives via env."""
    entrypoint: Sequence[str]
    local_world_size: int
    max_restarts: int = 3
    monitor_interval: float = 0.2
    master_addr: str = "127.0.0.1"
    master_port: int = 29500


class DSElasticAgent:
    """Single-node elastic supervisor (multi-node composition happens at the
    runner level, one agent per node, like the reference's per-node
    LocalElasticAgent)."""

    def __init__(self, spec: WorkerSpec, env: Optional[Dict[str, str]] = None,
                 ds_config: Optional[dict] = None,
                 capacity_fn: Optional[Callable[[], int]] = None):
        self.spec = spec
        self.ds_env = dict(env or {})
        self.ds_config = ds_config
        # membership probe: how many local workers can run right now
        self.capacity_fn = capacity_fn or (lambda: spec.local_world_size)
        self._procs: List[subprocess.Popen] = []

    # -------------------- group lifecycle -------------------- #

    def _admissible_world(self, capacity: int) -> int:
        """Largest world size <= capacity valid under the elastic plan."""
        if capacity < 1:
            # a zero-worker group would vacuously "succeed" without running
            raise RuntimeError(f"no capacity ({capacity}) to run any worker")
        if not self.ds_config:
            return capacity
        from deepspeed_tpu_torch.elasticity import compute_elastic_config
        _, valid_worlds = compute_elastic_config(self.ds_config)
        fitting = [w for w in valid_worlds if w <= capacity]
        if not fitting:
            raise RuntimeError(
                f"no elastic-valid world size fits capacity {capacity} "
                f"(valid: {valid_worlds})")
        return max(fitting)

    def _start_group(self, world: int, restart_count: int) -> None:
        world_info = {"localhost": list(range(world))}
        self._procs = []
        for lr in range(world):
            env = os.environ.copy()
            env.update(self.ds_env)
            env.update(build_rank_env(world_info, 0, lr,
                                      self.spec.master_addr,
                                      self.spec.master_port))
            env["DSTPU_RESTART_COUNT"] = str(restart_count)
            env["DSTPU_MAX_RESTARTS"] = str(self.spec.max_restarts)
            self._procs.append(subprocess.Popen(
                list(self.spec.entrypoint), env=env))
        logger.info(f"elastic agent: started {world} workers "
                    f"(attempt {restart_count})")

    def _stop_group(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.time() + 5.0
        for p in self._procs:
            timeout = max(0.0, deadline - time.time())
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()  # reap, so poll() reports the kill instead of None

    def _monitor(self) -> Optional[List[int]]:
        """None while running; exit codes once every worker has exited or
        any worker has failed (the group is then stopped)."""
        codes = [p.poll() for p in self._procs]
        if any(c not in (None, 0) for c in codes):
            self._stop_group()
            return [p.poll() for p in self._procs]
        if all(c is not None for c in codes):
            return codes
        return None

    # -------------------- run loop -------------------- #

    def run(self) -> RunResult:
        restart_count = 0
        capacity = self.capacity_fn()  # probe errors propagate (caller bug)
        try:
            world = self._admissible_world(capacity)
        except RuntimeError as e:
            # no admissible world at startup -> a failed result, not a crash
            logger.error(f"elastic agent: {e}")
            return RunResult(WorkerState.FAILED, [], 0)
        self._start_group(world, restart_count)
        while True:
            time.sleep(self.spec.monitor_interval)
            codes = self._monitor()
            if codes is None:
                continue
            if all(c == 0 for c in codes):
                return RunResult(WorkerState.SUCCEEDED, codes, restart_count)

            new_capacity = self.capacity_fn()
            try:
                new_world = self._admissible_world(new_capacity)
            except RuntimeError:
                logger.error("elastic agent: no admissible world size left")
                return RunResult(WorkerState.FAILED, codes, restart_count)

            # only a genuine scale-DOWN is a free attempt (the failure is
            # explained by lost capacity); anything else — same-capacity
            # crashes, flapping, scale-up — consumes restart budget, so a
            # crashing job can't loop forever behind capacity noise
            scaled = new_world < world
            if not scaled:
                restart_count += 1
            if restart_count > self.spec.max_restarts:
                logger.error(f"elastic agent: exceeded max_restarts "
                             f"({self.spec.max_restarts})")
                return RunResult(WorkerState.FAILED, codes, restart_count)

            logger.warning(
                f"elastic agent: workers failed {codes}; "
                f"{'rescaling to ' + str(new_world) if scaled else 'restarting'}"
                f" (attempt {restart_count}/{self.spec.max_restarts})")
            world = new_world
            self._start_group(world, restart_count)
