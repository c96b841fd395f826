"""The engine-built optimizers of the fourth slice and MoQ, through
``deepspeed_tpu_torch.initialize(..., device="cpu") + train_batch`` against
the JAX engine on a one-device mesh (its Pallas kernels in interpret mode),
same weights, same batches, fp32, on the tiny Llama and GPT-2 of
``test_torch_training.py`` (2 layers): lamb, fusedlamb (the K7 plain
versions), sgd with momentum (plain and nesterov), lion and adagrad, each
over 3 steps of gas 2 with clipping and WarmupLR; MoQ with nearest rounding
over 6 steps, Quantizer state included; resumption from each JAX optimizer
state; and that the trust ratio and the quantizer groups must be taken per
stacked JAX leaf (one per port leaf misses at 2 layers)."""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu_torch.checkpoint.from_jax import opt_state_from_jax, params_from_jax
from deepspeed_tpu_torch.models import TransformerConfig
from deepspeed_tpu_torch.runtime import optimizers as popt
from tests.test_torch_training import (GPT2, LEAF_TOL, LLAMA, LOSS_TOL, _batches, _config,
                                       _jax_params, _leaf_errs, _port, one_device_mesh)  # noqa: F401

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

OPTIMIZERS = {
    "lamb": {"type": "Lamb", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "fusedlamb": {"type": "FusedLamb", "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                                                  "weight_decay": 0.01}},
    "sgd": {"type": "SGD", "params": {"lr": 3e-4, "momentum": 0.9, "weight_decay": 0.01}},
    "sgd_nesterov": {"type": "SGD", "params": {"lr": 3e-4, "momentum": 0.9, "nesterov": True}},
    "lion": {"type": "Lion", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 3e-4, "weight_decay": 0.01}},
}
# Lion's update is sign((1 - b1) g + b1 m): where that argument is a few
# ulps from 0, fp32 rounding in another order flips the sign and moves the
# element by 2 lr against the JAX engine. Such elements are rare (a share of
# a leaf below SIGN_FLIP_SHARE) and move by at most 2 lr a step; every other
# element stays within LEAF_TOL.
SIGN_FLIP_SHARE = 1e-3
MOQ = {"enabled": True, "quantize_groups": 2,
       "quantize_bits": {"start_bits": 10, "target_bits": 8},
       "quantize_schedule": {"quantize_period": 1},
       "quantize_algo": {"q_type": "symmetric", "q_rounding": "nearest"}}


def _engines(mesh, kw, seed, config):
    jmodel, jparams = _jax_params(kw, seed=seed)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=mesh)
    return jeng, _port(kw, jparams, config), jparams


def _stacked_leaf_diffs(peng, jeng):
    """|port - jax| and max |jax| per stacked JAX leaf (numpy)."""
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    got = params_to_jax(peng.module.config, peng.state.params)
    want = jax.tree.map(np.asarray, jeng.state.params)
    return jax.tree.map(lambda a, b: (np.abs(a - b), np.abs(b).max()), got, want,
                        is_leaf=lambda x: isinstance(x, np.ndarray))


def _assert_leaves_close(peng, jeng, opt, steps):
    """Every stacked leaf within LEAF_TOL of the JAX engine's (the zero-
    gradient key bias and Lion's sign flips as stated); ``steps`` the global
    steps taken in both engines."""
    lr_sum = sum(peng._lr_fn(s) for s in steps)
    diffs = _stacked_leaf_diffs(peng, jeng)
    flat = jax.tree_util.tree_flatten_with_path(diffs, is_leaf=lambda x: isinstance(x, tuple))[0]
    for path, (d, scale) in flat:
        key = jax.tree_util.keystr(path)
        if key.endswith("['bk']"):
            # the key bias's exact gradient is zero (softmax ignores a shift
            # of a row of logits): each package moves it by rounding noise,
            # up to ~lr a step under a normalising optimizer
            assert d.max() <= 2 * lr_sum, key
            continue
        bad = d > LEAF_TOL * scale
        if opt == "lion":
            assert bad.mean() <= SIGN_FLIP_SHARE and d.max() <= 2 * lr_sum * 1.01, key
        else:
            assert not bad.any(), (key, float(d.max() / scale))


@pytest.mark.parametrize("shape", ["llama", "gpt2"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_engine_matches_jax_engine(one_device_mesh, opt, shape):  # noqa: F811
    kw = {"llama": LLAMA, "gpt2": GPT2}[shape]
    config = _config(optimizer=OPTIMIZERS[opt])
    jeng, peng, jparams = _engines(one_device_mesh, kw, 6, config)
    for step, batch in enumerate(_batches(12, 3, 4)):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
    _assert_leaves_close(peng, jeng, opt, range(3))


def test_optimizer_defaults_and_state_types():
    lamb = popt.build_optimizer("fusedlamb")
    assert isinstance(lamb, popt.Lamb) and lamb.eps == 1e-6 and lamb.group_update
    assert isinstance(popt.build_optimizer("lamb"), popt.Lamb)
    lion = popt.build_optimizer("lion")
    assert (lion.b1, lion.b2) == (0.9, 0.99)
    assert popt.build_optimizer("adagrad").eps == 1e-10
    sgd = popt.build_optimizer("sgd", {"momentum": 0.9, "nesterov": True})
    assert sgd.momentum == 0.9 and sgd.nesterov and sgd.group_update is None


def _assert_moq_close(peng, jeng, bits):
    """Every element within LEAF_TOL, but those where the two packages'
    fp32 noise put x / scale on either side of a rounding boundary: a share
    below 1e-3 of the leaf, each one quantization step off (the step is the
    group's max / qmax, at most the leaf's max / qmax)."""
    qmax = 2 ** (bits - 1) - 1
    diffs = _stacked_leaf_diffs(peng, jeng)
    for d, scale in jax.tree.leaves(diffs, is_leaf=lambda x: isinstance(x, tuple)):
        bad = d > LEAF_TOL * scale
        assert bad.mean() <= 1e-3
        assert d.max() <= scale / qmax * 1.01 + LEAF_TOL * scale


def test_moq_engine_matches_jax_engine(one_device_mesh):  # noqa: F811
    """FusedLamb + quantize_training (nearest, 10 -> 8 bits, period 1) over
    6 steps: losses, params and the Quantizer's state."""
    config = _config(optimizer=OPTIMIZERS["fusedlamb"], quantize_training=MOQ)
    jeng, peng, jparams = _engines(one_device_mesh, LLAMA, 8, config)
    assert peng.quantizer is not None
    for step, batch in enumerate(_batches(13, 6, 4)):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
        assert peng.quantizer.state_dict() == jeng.quantizer.state_dict(), step
    state = peng.quantizer.state_dict()
    assert state["qsteps"] == 6
    assert {v["bits"] for v in state["leaf_state"].values()} == {8}
    assert "['layers']['ln_attn']['scale']" in state["leaf_state"]      # stacked rank 2
    assert "['ln_f']['scale']" not in state["leaf_state"]               # rank 1
    _assert_moq_close(peng, jeng, 8)


def test_moq_stochastic_engine_runs_on_its_grid(one_device_mesh):  # noqa: F811
    """Stochastic rounding draws other bits than the JAX package's, so the
    port is held to the schedule and to the grid: after each step every
    quantized stacked leaf lies on its groups' 8-bit grid."""
    moq = {**MOQ, "quantize_bits": {"start_bits": 8, "target_bits": 8},
           "quantize_algo": {"q_type": "symmetric", "q_rounding": "stochastic"}}
    config = _config(optimizer=OPTIMIZERS["lamb"], quantize_training=moq)
    jeng, peng, jparams = _engines(one_device_mesh, LLAMA, 9, config)
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    for batch in _batches(14, 2, 4):
        jeng.train_batch(batch)
        assert np.isfinite(float(peng.train_batch(batch)))
        assert peng.quantizer.state_dict() == jeng.quantizer.state_dict()
        tree = params_to_jax(peng.module.config, peng.state.params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            if leaf.ndim < 2:
                continue
            flat = leaf.reshape(2, -1)
            scale = np.abs(flat).max(1, keepdims=True) / 127
            q = flat / scale
            assert np.abs(q - np.round(q)).max() < 1e-3, jax.tree_util.keystr(path)


@pytest.mark.parametrize("opt", ["lamb", "fusedlamb", "sgd", "lion", "adagrad"])
def test_resume_from_jax_optimizer_state(one_device_mesh, opt):  # noqa: F811
    """Two steps in the JAX engine, then params and the optimizer state
    carried into the port; step 3 in both lands on the same params."""
    config = _config(optimizer=OPTIMIZERS[opt])
    jeng, peng, jparams = _engines(one_device_mesh, LLAMA, 10, config)
    b1, b2, b3 = _batches(15, 3, 4)
    jeng.train_batch(b1)
    jeng.train_batch(b2)
    cfg = TransformerConfig(**LLAMA)
    state = opt_state_from_jax(cfg, peng._optimizer_name,
                               jax.tree.map(np.asarray, jeng.state.opt_state))
    assert type(state) is type(peng.state.opt_state)
    peng.load_train_state(params=params_from_jax(cfg, jax.tree.map(np.asarray, jeng.state.params)),
                          opt_state=state, global_steps=int(jeng.state.global_steps))
    want, got = float(jeng.train_batch(b3)), float(peng.train_batch(b3))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    _assert_leaves_close(peng, jeng, opt, [2])


def test_load_train_state_refuses_another_optimizers_state(one_device_mesh):  # noqa: F811
    _, jparams = _jax_params(LLAMA)
    peng = _port(LLAMA, jparams, _config(optimizer=OPTIMIZERS["sgd"]))
    with pytest.raises(TypeError, match="SGDState"):
        peng.load_train_state(opt_state=popt.AdamState(count=0, mu={}, nu={}))


def test_per_port_leaf_trust_ratio_misses_the_jax_engine(one_device_mesh):  # noqa: F811
    """The trust ratio is ||p|| / ||u|| over the stacked JAX leaf: an engine
    that took it per port leaf (one group per layer) lands a layer leaf past
    LEAF_TOL from the JAX engine after one step at a constant lr of 0.05
    (the ratio's share of the step is what differs); the grouped engine
    does not."""
    config = _config(optimizer={"type": "FusedLamb", "params": {"lr": 0.05}})
    del config["scheduler"]
    jeng, peng, jparams = _engines(one_device_mesh, LLAMA, 12, config)
    per_leaf = _port(LLAMA, jparams, config)
    per_leaf._groups = [[n] for n in per_leaf._names]
    for batch in _batches(16, 1, 4):
        jeng.train_batch(batch)
        peng.train_batch(batch)
        per_leaf.train_batch(batch)
    want = jeng.state.params
    assert max(jax.tree.leaves(_leaf_errs(peng.module.config, peng, want))) <= LEAF_TOL
    errs = _leaf_errs(per_leaf.module.config, per_leaf, want)
    assert max(jax.tree.leaves(errs["layers"])) > 3 * LEAF_TOL     # 7.8x at seed 12


def test_per_port_leaf_quantize_misses_the_jax_engine(one_device_mesh):  # noqa: F811
    """MoQ groups run over the flattened stacked leaf: quantizing each port
    leaf as a leaf of its own (its own groups; the [D] norm scales skipped
    as rank 1) lands past the tolerance after one step."""
    config = _config(optimizer=OPTIMIZERS["fusedlamb"], quantize_training=MOQ)
    jeng, peng, jparams = _engines(one_device_mesh, LLAMA, 13, config)
    per_leaf = _port(LLAMA, jparams, config)
    from deepspeed_tpu_torch.runtime import quantize as pq
    batch = _batches(17, 1, 4)[0]
    jeng.train_batch(batch)
    peng.train_batch(batch)
    real = pq.jax_leaves
    pq.jax_leaves = lambda names: {(n,): [n] for n in sorted(names)}
    try:
        per_leaf.train_batch(batch)
    finally:
        pq.jax_leaves = real
    _assert_moq_close(peng, jeng, 10)
    errs = _leaf_errs(per_leaf.module.config, per_leaf, jeng.state.params)
    assert max(jax.tree.leaves(errs["layers"])) > 100 * LEAF_TOL


@pytest.mark.parametrize("over,match", [
    ({"optimizer": {"type": "OneBitLamb", "params": {}}}, "onebit"),
    ({"optimizer": {"type": "ZeroOneAdam", "params": {}}}, "onebit"),
])
def test_new_refusals_name_their_item(over, match):
    _, jparams = _jax_params(LLAMA)
    with pytest.raises(NotImplementedError, match=match):
        _port(LLAMA, jparams, _config(**over))


def test_eigenvalue_moq_is_built_as_the_jax_engine_builds_it():
    """quantize_training.eigenvalue, refused before runtime/eigenvalue.py was
    ported: the engine builds the Eigenvalue with the JAX engine's keys and
    defaults, and the Quantizer with q_eigenvalue."""
    _, jparams = _jax_params(LLAMA)
    ev = {"enabled": True, "max_iter": 7, "tol": 0.05, "layer_name": "layers",
          "layer_num": 2, "verbose": True}
    eng = _port(LLAMA, jparams, _config(quantize_training={**MOQ, "eigenvalue": ev}))
    assert eng.quantizer.q_eigenvalue
    e = eng.eigenvalue
    assert (e.max_iter, e.tol, e.stability, e.gas_boundary_resolution, e.verbose) == \
        (7, 0.05, 1e-6, 1, True)
    assert (eng._ev_layer_name, eng._ev_layer_num) == ("layers", 2)
    off = _port(LLAMA, jparams, _config(quantize_training={**MOQ, "eigenvalue": {}}))
    assert off.eigenvalue is None and not off.quantizer.q_eigenvalue


def test_quantize_training_is_off_unless_enabled():
    _, jparams = _jax_params(LLAMA)
    off = {k: v for k, v in MOQ.items() if k != "enabled"}
    assert _port(LLAMA, jparams, _config(quantize_training=off)).quantizer is None
