"""The port's elastic agent (``elasticity/elastic_agent.py``) in the six
scenarios of the JAX package's ``tests/unit/test_elastic_agent.py``, with
the same outcomes: success at the first try, restarts until success, the
restart budget exceeded, a scale-down not counted against it, no admissible
world, and flapping capacity still bounded. The workers are plain Python
scripts (no torch): the agent's rank environment, ``DSTPU_RESTART_COUNT``
and the elastic plan's world size decide what they do."""

import sys
import textwrap

import pytest

import torch

from deepspeed_tpu_torch.elasticity.elastic_agent import (DSElasticAgent, RunResult, WorkerSpec,
                                                          WorkerState)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def _script(tmp_path, body):
    p = tmp_path / "worker.py"
    p.write_text(textwrap.dedent(body))
    return [sys.executable, str(p)]


def test_success_first_try(tmp_path):
    spec = WorkerSpec(entrypoint=_script(tmp_path, """
        import os
        assert "RANK" in os.environ and "WORLD_SIZE" in os.environ
    """), local_world_size=2, monitor_interval=0.05)
    res = DSElasticAgent(spec).run()
    assert isinstance(res, RunResult)
    assert res.state == WorkerState.SUCCEEDED
    assert res.restarts == 0
    assert res.return_codes == [0, 0]


def test_restart_until_success(tmp_path):
    """Workers fail twice (shared counter file), then succeed; env carries
    the attempt number."""
    marker = tmp_path / "attempts"
    spec = WorkerSpec(entrypoint=_script(tmp_path, f"""
        import os, sys
        n = int(os.environ["DSTPU_RESTART_COUNT"])
        open({str(marker)!r} + str(n), "w").write(os.environ["RANK"])
        sys.exit(0 if n >= 2 else 1)
    """), local_world_size=2, max_restarts=3, monitor_interval=0.05)
    res = DSElasticAgent(spec).run()
    assert res.state == WorkerState.SUCCEEDED
    assert res.restarts == 2
    assert (tmp_path / "attempts0").exists()
    assert (tmp_path / "attempts2").exists()


def test_max_restarts_exceeded(tmp_path):
    spec = WorkerSpec(entrypoint=_script(tmp_path, "raise SystemExit(3)"),
                      local_world_size=1, max_restarts=1,
                      monitor_interval=0.05)
    res = DSElasticAgent(spec).run()
    assert res.state == WorkerState.FAILED
    assert res.restarts == 2  # attempted 0, 1, then gave up
    assert 3 in res.return_codes


def test_scale_down_does_not_count_as_restart(tmp_path):
    """Capacity drops 4 → 2 after the first failure: the agent rescales to
    the largest elastic-valid world and the scale event is free."""
    capacities = iter([4, 2, 2, 2, 2])
    seen = []

    def capacity():
        c = next(capacities, 2)
        seen.append(c)
        return c

    marker = tmp_path / "world"
    spec = WorkerSpec(entrypoint=_script(tmp_path, f"""
        import os, sys
        ws = os.environ["WORLD_SIZE"]
        open({str(marker)!r} + ws, "w").write("1")
        sys.exit(0 if ws == "2" else 1)   # die until scaled down to 2
    """), local_world_size=4, max_restarts=0, monitor_interval=0.05)
    ds_config = {"train_batch_size": 8,
                 "elasticity": {"enabled": True, "max_train_batch_size": 8,
                                "micro_batch_sizes": [1, 2], "min_gpus": 1,
                                "max_gpus": 4, "min_time": 0,
                                "version": 0.1}}
    res = DSElasticAgent(spec, ds_config=ds_config, capacity_fn=capacity).run()
    assert res.state == WorkerState.SUCCEEDED
    # rescale 4 -> 2 consumed zero restart budget (max_restarts=0)
    assert res.restarts == 0
    assert (tmp_path / "world4").exists()
    assert (tmp_path / "world2").exists()


def test_no_admissible_world_fails(tmp_path):
    spec = WorkerSpec(entrypoint=_script(tmp_path, "raise SystemExit(1)"),
                      local_world_size=2, max_restarts=5,
                      monitor_interval=0.05)
    ds_config = {"train_batch_size": 8,
                 "elasticity": {"enabled": True, "max_train_batch_size": 8,
                                "micro_batch_sizes": [2], "min_gpus": 2,
                                "max_gpus": 4, "min_time": 0,
                                "version": 0.1}}
    caps = iter([2, 0])
    res = DSElasticAgent(spec, ds_config=ds_config,
                         capacity_fn=lambda: next(caps, 0)).run()
    assert res.state == WorkerState.FAILED


def test_flapping_capacity_still_bounded(tmp_path):
    """A crashing job behind oscillating capacity cannot loop forever:
    only genuine scale-DOWNs are free attempts."""
    caps = iter([2, 4, 2, 4, 2, 4])
    spec = WorkerSpec(entrypoint=_script(tmp_path, "raise SystemExit(1)"),
                      local_world_size=2, max_restarts=2,
                      monitor_interval=0.05)
    res = DSElasticAgent(spec, capacity_fn=lambda: next(caps, 2)).run()
    assert res.state == WorkerState.FAILED
    assert res.restarts == 3  # bounded despite capacity noise
