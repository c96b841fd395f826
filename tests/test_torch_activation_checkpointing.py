"""``deepspeed_tpu_torch.checkpointing`` (``runtime/activation_checkpointing``)
against the JAX package's module on the CPU: ``configure`` / ``is_configured``
/ ``reset`` leave the same recorded settings from the same arguments and
config sections; ``checkpoint(fn, *args)`` and ``checkpoint_wrapper`` give
``fn``'s value and gradients (full remat, and the offload policy that
``cpu_checkpointing`` selects) and the JAX ``checkpoint``'s within fp32
rounding; the config section parses as the JAX config parses it. The RNG
tracker draws from ``torch.Generator``s, which cannot share a JAX key's
stream, so it is held by its properties: forks differ, tp ranks differ,
reseeding repeats the stream, the model-parallel seed is ``seed + 2718 +
tp_rank``, and ``get_states`` / ``set_states`` restore a stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jck
from deepspeed_tpu.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig as JaxACConfig)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TOL = 1e-6          # relative, fp32 (tanh and products in another order)


@pytest.fixture(autouse=True)
def fresh():
    ck.reset()
    jck.reset()
    yield
    ck.reset()
    jck.reset()


def test_lazy_export():
    assert deepspeed_tpu_torch.checkpointing is ck


@pytest.mark.parametrize("kwargs", [
    {"deepspeed_config": {"activation_checkpointing": {"partition_activations": True,
                                                       "cpu_checkpointing": False}}},
    {"deepspeed_config": {"activation_checkpointing": {"cpu_checkpointing": True,
                                                       "number_checkpoints": 3,
                                                       "profile": True}},
     "synchronize": True},
    {"partition_activations": True, "contiguous_checkpointing": True, "num_checkpoints": 2,
     "checkpoint_in_cpu": True, "synchronize": False, "profile": True},
    {},
])
def test_configure_records_what_jax_records(kwargs):
    assert not ck.is_configured() and not jck.is_configured()
    ck.configure(**kwargs)
    jck.configure(**kwargs)
    assert ck.is_configured() and jck.is_configured()
    assert ck._config == jck._config
    assert ck._policy() == ("offload_dots" if jck._config["cpu_checkpointing"] else "full")
    ck.reset()
    jck.reset()
    assert ck._config == jck._config and not ck.is_configured()


def test_configure_from_a_parsed_config():
    from deepspeed_tpu.config.core import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.config.core import DeepSpeedConfig
    cfg = {"train_batch_size": 2,
           "activation_checkpointing": {"cpu_checkpointing": True, "number_checkpoints": 4}}
    ck.configure(deepspeed_config=DeepSpeedConfig(cfg))
    jck.configure(deepspeed_config=JaxConfig(cfg, world_size=1))
    assert ck._config == jck._config


@pytest.mark.parametrize("section", [{}, {"cpu_checkpointing": True, "number_checkpoints": 8},
                                     {"partition_activations": True, "profile": True}])
def test_config_section_parses_as_jax(section):
    got, want = DeepSpeedActivationCheckpointingConfig(**section), JaxACConfig(**section)
    for key in ("partition_activations", "contiguous_memory_optimization", "cpu_checkpointing",
                "number_checkpoints", "synchronize_checkpoint_boundary", "profile"):
        assert getattr(got, key) == getattr(want, key), key


def _inputs():
    r = np.random.default_rng(0)
    return (r.standard_normal((8, 16)).astype(np.float32),
            r.standard_normal((16, 16)).astype(np.float32) * 0.3)


@pytest.mark.parametrize("cpu_checkpointing", [False, True])
@pytest.mark.parametrize("form", ["checkpoint", "wrapper"])
def test_checkpoint_matches_plain_and_jax(cpu_checkpointing, form):
    x, w = _inputs()
    ck.configure(checkpoint_in_cpu=cpu_checkpointing)
    jck.configure(checkpoint_in_cpu=cpu_checkpointing)

    def fn(x, w):
        return torch.tanh(torch.tanh(x @ w) @ w).sum()

    def jfn(x, w):
        return jnp.tanh(jnp.tanh(x @ w) @ w).sum()

    ck.reset_stats()
    run = (lambda *a: ck.checkpoint(fn, *a)) if form == "checkpoint" else ck.checkpoint_wrapper(fn)
    results = []
    for f in (fn, run):
        xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        v = f(xt, wt)
        v.backward()
        results.append((v.detach(), xt.grad, wt.grad))
    (pv, pgx, pgw), (cv, cgx, cgw) = results
    assert torch.equal(cv, pv) and torch.equal(cgx, pgx) and torch.equal(cgw, pgw)
    # the offload policy kept the two products; full remat kept nothing
    assert ck.stats["saved_bytes"] == (2 * 8 * 16 * 4 if cpu_checkpointing else 0)
    jrun = (lambda *a: jck.checkpoint(jfn, *a)) if form == "checkpoint" \
        else jck.checkpoint_wrapper(jfn)
    jv, (jgx, jgw) = jax.value_and_grad(jrun, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert float(cv) == pytest.approx(float(jv), rel=TOL)
    for got, want in ((cgx, jgx), (cgw, jgw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("policy", ["dots", "offload_dots"])
def test_a_second_backward_through_kept_outputs_raises(policy):
    """Each kept output is handed to the one recompute that consumes it, as
    torch's selective checkpoint allows one backward: a retained graph's
    second backward raises (full remat recomputes again and runs)."""
    x = torch.from_numpy(_inputs()[0]).requires_grad_()
    y = ck.remat(policy, lambda t: torch.tanh(t @ t.T).sum(), x)
    y.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="second backward"):
        y.backward()
    y = ck.remat("full", lambda t: torch.tanh(t @ t.T).sum(), x)
    y.backward(retain_graph=True)
    y.backward()


def test_rng_tracker():
    ck.model_parallel_seed(1234, tp_rank=0)
    t = ck.get_rng_tracker()
    draw = lambda g: torch.rand(8, generator=g)
    a, b = draw(t.fork()), draw(t.fork())
    assert not torch.equal(a, b)
    ck.model_parallel_seed(1234, tp_rank=1)
    assert not torch.equal(a, draw(ck.get_rng_tracker().fork()))
    ck.model_parallel_seed(1234, tp_rank=0)
    assert torch.equal(a, draw(ck.get_rng_tracker().fork()))
    # the stream's seed is seed + 2718 + tp_rank, as in the JAX package
    ck.model_parallel_seed(100, tp_rank=3)
    got = ck.get_rng_tracker().fork()
    want = torch.Generator().manual_seed(100 + 2718 + 3)
    seed = int(torch.randint(0, 2**62, (1,), generator=want))
    assert torch.equal(draw(got), draw(torch.Generator().manual_seed(seed)))
    # get_states / set_states restore a stream
    tracker = ck.get_rng_tracker()
    saved = tracker.get_states()
    first = draw(tracker.fork())
    tracker.set_states(saved)
    assert torch.equal(draw(tracker.fork()), first)
    with pytest.raises(ValueError, match="already exists"):
        tracker.add("model-parallel-rng", 1)
    with pytest.raises(ValueError, match="never seeded"):
        tracker.fork("other")
