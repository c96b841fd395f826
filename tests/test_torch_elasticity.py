"""Elastic batch planning (``deepspeed_tpu_torch/elasticity/``) against the
JAX package's ``elasticity/``: ``compute_elastic_config`` over a table of
configs (v0.1, v0.2 with nodes and model parallelism, world sizes, the
micro-batch alone) gives the JAX result (limit 0); every error case raises
the JAX exception with the JAX message; the training config reads the
``elasticity`` section as the JAX config does; ``cli elastic`` prints what
the JAX ``dscli elastic`` prints."""

import dataclasses
import enum
import json

import pytest
import torch

from deepspeed_tpu import cli as jax_cli
from deepspeed_tpu import elasticity as jel
from deepspeed_tpu.config.core import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch import elasticity as pel
from deepspeed_tpu_torch.config.core import DeepSpeedConfig

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def _el(**kw):
    return {"elasticity": {"enabled": True, **kw}}


PLANS = {
    "v01_default": _el(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6], version=0.1),
    "v01_small": _el(max_train_batch_size=64, micro_batch_sizes=[2, 4], min_gpus=1, max_gpus=8,
                     version=0.1),
    "v01_prefer_smaller": _el(max_train_batch_size=1000, micro_batch_sizes=[3, 5],
                              prefer_larger_batch=False, version=0.1),
    "v01_one_micro": _el(max_train_batch_size=100, micro_batch_sizes=[8], min_gpus=2,
                         max_gpus=16, version=0.1),
    "v02_default": _el(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6]),
    "v02_nodes": _el(max_train_batch_size=4096, micro_batch_sizes=[1, 2, 4], min_gpus=8,
                     max_gpus=128, num_gpus_per_node=8),
    "v02_mp": _el(max_train_batch_size=1024, micro_batch_sizes=[2, 4], min_gpus=4, max_gpus=64,
                  num_gpus_per_node=4, model_parallel_size=2),
    "v02_small": _el(max_train_batch_size=64, micro_batch_sizes=[2, 4], min_gpus=1, max_gpus=8),
}
ERRORS = {
    "disabled": {"elasticity": {"enabled": False}},
    "missing_section": {},
    "no_max_batch": {"elasticity": {"enabled": True, "micro_batch_sizes": [2]}},
    "no_micro": {"elasticity": {"enabled": True, "max_train_batch_size": 10}},
    "micro_not_list": _el(max_train_batch_size=10, micro_batch_sizes=4),
    "micro_not_int": _el(max_train_batch_size=10, micro_batch_sizes=[2.5]),
    "micro_not_positive": _el(max_train_batch_size=10, micro_batch_sizes=[0, 2]),
    "min_gpus_zero": _el(max_train_batch_size=10, micro_batch_sizes=[2], min_gpus=0),
    "min_above_max": _el(max_train_batch_size=10, micro_batch_sizes=[2], min_gpus=4, max_gpus=2),
    "mp_zero": _el(max_train_batch_size=10, micro_batch_sizes=[2], model_parallel_size=0),
    "gpus_per_node_zero": _el(max_train_batch_size=10, micro_batch_sizes=[2],
                              num_gpus_per_node=0),
    "negative_min_time": _el(max_train_batch_size=10, micro_batch_sizes=[2], min_time=-1),
    "unknown_version": _el(max_train_batch_size=10, micro_batch_sizes=[2], version=0.3),
    "micro_above_max_v01": _el(max_train_batch_size=4, micro_batch_sizes=[8], version=0.1),
    "mp_not_dividing_node": _el(max_train_batch_size=64, micro_batch_sizes=[2],
                                num_gpus_per_node=4, model_parallel_size=3),
}


def _both(fn_name, *args, **kw):
    """(port result or exception, JAX result or exception)."""
    out = []
    for mod in (pel, jel):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:      # noqa: BLE001 - compared below
            out.append(e)
    return out


def _same(got, want):
    if isinstance(want, Exception):
        assert isinstance(got, Exception), got
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
    else:
        assert got == want


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_equals_jax(name):
    got, want = _both("compute_elastic_config", PLANS[name])
    assert not isinstance(want, Exception), want
    _same(got, want)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_world_size_plans_equal_jax(name):
    _, valid = jel.compute_elastic_config(PLANS[name])
    for world in sorted({1, 2, 3, 8, valid[0], valid[-1], valid[len(valid) // 2]}):
        _same(*_both("compute_elastic_config", PLANS[name], world_size=world))
        _same(*_both("compute_elastic_config", PLANS[name], world_size=world,
                     return_microbatch=True))


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_equal_jax(name):
    got, want = _both("compute_elastic_config", ERRORS[name])
    assert isinstance(want, Exception)
    _same(got, want)


@pytest.mark.parametrize("base", [[1], [2, 4, 6], [3, 7, 9, 300], [5000]])
@pytest.mark.parametrize("max_batch", [1, 100, 2000, 720720 * 2])
def test_candidate_batch_sizes_and_valid_gpus_equal_jax(base, max_batch):
    _same(*_both("get_candidate_batch_sizes", base, max_batch))
    _same(*_both("get_valid_gpus", 720, base, 1, 64))
    assert pel.HCN_LIST == jel.elasticity.HCN_LIST


def test_immutable_config_guard_like_jax(monkeypatch):
    monkeypatch.delenv("DEEPSPEED_ELASTICITY_CONFIG", raising=False)
    section = PLANS["v02_small"]["elasticity"]
    pel.ensure_immutable_elastic_config(section)            # records it
    pel.ensure_immutable_elastic_config(section)            # the same: accepted
    with pytest.raises(pel.ElasticityConfigError, match="changed between"):
        pel.ensure_immutable_elastic_config({**section, "max_train_batch_size": 32})


@pytest.mark.parametrize("name", ["v01_small", "v02_nodes"])
def test_training_config_reads_the_section_like_jax(name):
    cfg = {"train_batch_size": 4, **PLANS[name]}
    got, want = DeepSpeedConfig(cfg), JaxConfig(cfg, world_size=1)
    assert got.elasticity_enabled == want.elasticity_enabled is True
    assert got.elasticity_config.repr() == want.elasticity_config.repr()
    off = DeepSpeedConfig({"train_batch_size": 4})
    assert off.elasticity_enabled is False and off.elasticity_config is None


@pytest.mark.parametrize("world", [0, 1, 4])
def test_cli_prints_the_jax_plan(world, tmp_path, capsys):
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps(PLANS["v02_nodes" if world == 4 else "v02_small"]))
    if world == 4:          # a world size the v0.2 plan refuses: both raise alike
        with pytest.raises(pel.ElasticityIncompatibleWorldSize) as got:
            cli.main(["elastic", str(path), "-w", "4"])
        with pytest.raises(jel.ElasticityIncompatibleWorldSize) as want:
            jax_cli._elastic([str(path), "-w", "4"])
        assert str(got.value) == str(want.value)
        return
    argv = [str(path)] + (["-w", str(world)] if world else [])
    assert cli.main(["elastic", *argv]) == 0
    got = capsys.readouterr().out
    jax_cli._elastic(argv)
    assert got == capsys.readouterr().out


@pytest.mark.parametrize("name", ["DSElasticAgent", "WorkerSpec", "WorkerState", "RunResult"])
def test_the_agent_is_refused_by_its_item(name):
    """The agent's names, refused until the agent was ported: each is now
    the port's own (``elasticity/elastic_agent.py``), with the JAX one's
    fields or members (``tests/test_torch_elastic_agent.py`` runs it)."""
    from deepspeed_tpu_torch.elasticity import elastic_agent
    got, want = getattr(pel, name), getattr(jel, name)
    assert got is getattr(elastic_agent, name) and got.__module__ == elastic_agent.__name__
    if dataclasses.is_dataclass(want):
        assert [(f.name, f.default) for f in dataclasses.fields(got)] == \
            [(f.name, f.default) for f in dataclasses.fields(want)]
    elif isinstance(want, type) and issubclass(want, enum.Enum):
        assert [(m.name, m.value) for m in got] == [(m.name, m.value) for m in want]
