"""Client optimizers in the port against the JAX engine's client optax
chains: a 2-layer Llama at d 64 in both packages (weights carried across
with ``checkpoint/from_jax.py``), fp32, clipping 1.0, gas 2, 3 steps, on a
one-device JAX mesh. ``optax.sgd(1e-2, momentum=0.9)`` against
``torch.optim.SGD`` and ``optax.adamw(1e-3, weight_decay=0.01)`` against
``torch.optim.AdamW``, each given to the port both as a callable over the
engine's tensors and as an optimizer built over ``model_parameters``:
losses within LOSS_TOL relative, each leaf within LEAF_TOL of its largest
|value| (for AdamW with the exception stated at NOISE_SHARE). Then the
rest of the surface: a bit-equal resume from a client
tag, the refusal of a tag whose optimizer state is another optimizer's
(engine-built, a JAX client-optax tag), the scheduler warning,
``get_type`` / ``get_mom``, the offload ``ValueError`` and the binding
checks."""

import jax
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.runtime import engine as port_engine
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import CheckpointCorruptError
from tests.test_torch_training import _batches, _jax_params, one_device_mesh  # noqa: F401

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LOSS_TOL = 1e-5     # relative, per step
LEAF_TOL = 1e-5     # max |port - jax| over a leaf / max |jax| of the leaf
# Adam normalises each element's step: where an element's gradient sits at
# the fp32 noise floor of the loss, torch's AdamW (p (1 - lr wd), then
# lr / bc1 m / (sqrt(v) / sqrt(bc2) + eps)) and optax's adamw round the same
# formula in another order and the step moves by a share of lr. Such
# elements are rare (one of 16384 in a leaf here); every other element stays
# within LEAF_TOL, and they stay within NOISE_STEP lr of the JAX engine's.
# (The port's engine-built AdamW is 2.4e-5 off the JAX engine's at the same
# element for the same reason.)
NOISE_SHARE = 1e-3
NOISE_STEP = 0.02
LLAMA = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=2, n_kv_head=1, d_model=64, d_ff=128,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             norm_eps=1e-6, attention_backend="flash")
PAIRS = {
    "sgd": (lambda: optax.sgd(1e-2, momentum=0.9),
            lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9)),
    "adamw": (lambda: optax.adamw(1e-3, weight_decay=0.01),
              lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=0.01)),
}


def _config(gas=2, micro=2, **over):
    cfg = {"train_batch_size": gas * micro, "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
           "fused_cross_entropy": "off"}
    cfg.update(over)
    return cfg


def _port(jparams, optimizer, form="callable", config=None):
    """The port's engine over ``jparams`` with the client optimizer ``optimizer``
    (a callable over tensors), given as the callable or as an optimizer
    built over ``model_parameters``."""
    model = CausalLM(TransformerConfig(**LLAMA))
    params = params_from_jax(model.config, jparams)
    opt = optimizer if form == "callable" else optimizer(list(params.parameters()))
    engine, returned, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, optimizer=opt,
        config=config or _config(), device="cpu")
    assert returned is engine.client_optimizer and isinstance(returned, torch.optim.Optimizer)
    return engine


def _leaf_diffs(engine, jparams_now):
    """(|port - jax|, max |jax|) per JAX leaf."""
    got = params_to_jax(engine.module.config, engine.state.params)
    want = jax.tree.map(np.asarray, jparams_now)
    return jax.tree.leaves(jax.tree.map(lambda a, b: (np.abs(a - b), np.abs(b).max()),
                                        got, want), is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("form", ["callable", "instance"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_client_optimizer_matches_the_jax_client_chain(one_device_mesh, pair, form):  # noqa: F811
    jmodel, jparams = _jax_params(LLAMA, seed=4)
    jtx, ptx = PAIRS[pair]
    jeng, jopt, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                                optimizer=jtx(), config=_config(),
                                                mesh=one_device_mesh)
    peng = _port(jparams, ptx, form)
    assert jeng.get_type() == peng.get_type() == ["client"]
    for step, batch in enumerate(_batches(21, 3, 4)):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
    for i, (d, scale) in enumerate(_leaf_diffs(peng, jeng.state.params)):
        bad = d > LEAF_TOL * scale
        if pair == "adamw":
            assert bad.mean() <= NOISE_SHARE and d.max() <= NOISE_STEP * 1e-3, (i, d.max())
        else:
            assert not bad.any(), (i, float(d.max() / scale))


def test_callable_form_sees_the_jax_flatten_order_and_instance_form_the_tree_order():
    _, jparams = _jax_params(LLAMA, seed=4)
    seen = []

    def make(ps):
        seen.extend(ps)
        return torch.optim.SGD(ps, lr=1e-2)

    eng = _port(jparams, make)
    targets = eng._param_dict(eng.state.params)
    jax_order = [n for names in port_engine.jax_leaves(eng._names).values() for n in names]
    assert [id(t) for t in seen] == [id(targets[n]) for n in jax_order]
    assert eng._client_names == jax_order != eng._names
    inst = _port(jparams, lambda ps: torch.optim.SGD(ps, lr=1e-2), form="instance")
    held = inst.client_optimizer.param_groups[0]["params"]
    targets = inst._param_dict(inst.state.params)
    assert [id(p) for p in held] == [id(targets[n]) for n in inst._names]


def test_instance_form_rebinds_groups_and_keeps_their_hyperparameters():
    _, jparams = _jax_params(LLAMA, seed=4)
    model = CausalLM(TransformerConfig(**LLAMA))
    params = list(params_from_jax(model.config, jparams).parameters())
    opt = torch.optim.AdamW([{"params": params[:3], "lr": 5e-4},
                             {"params": params[3:], "weight_decay": 0.2}], lr=1e-3)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(
        model.config, jparams), optimizer=opt, config=_config(), device="cpu")
    g0, g1 = eng.client_optimizer.param_groups
    assert (g0["lr"], g1["lr"], g1["weight_decay"]) == (5e-4, 1e-3, 0.2)
    targets = eng._param_dict(eng.state.params)
    assert all(p is targets[n] for p, n in zip(g0["params"] + g1["params"], eng._names))
    eng.train_batch(_batches(2, 1, 4)[0])
    assert all(len(eng.client_optimizer.state[targets[n]]) == 3 for n in eng._names)


def test_binding_checks_count_shape_and_type():
    _, jparams = _jax_params(LLAMA, seed=4)
    model = CausalLM(TransformerConfig(**LLAMA))
    params = list(params_from_jax(model.config, jparams).parameters())
    with pytest.raises(ValueError, match="holds 3 tensors"):
        deepspeed_tpu_torch.initialize(model=model, optimizer=torch.optim.SGD(params[:3], lr=1.0),
                                       model_parameters=params_from_jax(model.config, jparams),
                                       config=_config(), device="cpu")
    swapped = [params[1], params[0]] + params[2:]
    with pytest.raises(ValueError, match="has shape"):
        deepspeed_tpu_torch.initialize(model=model, optimizer=torch.optim.SGD(swapped, lr=1.0),
                                       model_parameters=params_from_jax(model.config, jparams),
                                       config=_config(), device="cpu")
    with pytest.raises(TypeError, match="not a torch.optim.Optimizer"):
        _port(jparams, lambda ps: object())
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        _port(jparams, 3)


@pytest.mark.parametrize("gas", [2, 1])
def test_trio_matches_train_batch(gas):
    """The forward / backward / step trio with a client optimizer gives
    train_batch's losses and params bit for bit (gas 1: the micro-step
    grads feed the update without buffers)."""
    _, jparams = _jax_params(LLAMA, seed=6)
    config = _config(gas=gas, micro=4 // gas)
    a = _port(jparams, PAIRS["adamw"][1], config=config)
    b = _port(jparams, PAIRS["adamw"][1], config=config)
    for batch in _batches(25, 2, 4):
        want = float(a.train_batch(batch))
        got = []
        for i in range(gas):
            micro = {k: v[i * (4 // gas):(i + 1) * (4 // gas)] for k, v in batch.items()}
            got.append(float(b.backward(b(micro))))
            b.step()
        assert abs(sum(got) / gas - want) <= LOSS_TOL * abs(want)
    assert a.global_steps == b.global_steps == 2
    for (n, p), q in zip(a.state.params.named_parameters(), b.state.params.parameters()):
        assert torch.equal(p, q), n


def test_client_tag_resumes_bit_equal(tmp_path):
    _, jparams = _jax_params(LLAMA, seed=5)
    batches = _batches(22, 4, 4)
    ref = _port(jparams, PAIRS["adamw"][1])
    want = [float(ref.train_batch(b)) for b in batches]
    a = _port(jparams, PAIRS["adamw"][1])
    got = [float(a.train_batch(b)) for b in batches[:2]]
    a.save_checkpoint(str(tmp_path))
    import json
    meta = json.loads((tmp_path / "global_step2" / "meta.json").read_text())
    assert meta["optimizer"] == "client" and meta["client_optimizer"]["type"] == "AdamW"
    assert meta["client_optimizer"]["param_groups"][0]["lr"] == 1e-3
    labels = meta["opt_state_labels"]
    assert len(labels) == 3 * len(a._names)
    assert [lab["path"].rsplit(".", 1)[1] for lab in labels[:3]] == ["exp_avg", "exp_avg_sq",
                                                                       "step"]
    assert labels[0]["param"] == a._client_names[0]
    assert labels[0]["path"] == "client.state[0].exp_avg" and labels[0]["moment"] is None
    b = _port(jparams, PAIRS["adamw"][1])
    path, _ = b.load_checkpoint(str(tmp_path))
    assert path is not None and b.global_steps == 2
    got += [float(b.train_batch(x)) for x in batches[2:]]
    assert got == want
    for n, p in ref.state.params.named_parameters():
        assert torch.equal(p, dict(b.state.params.named_parameters())[n]), n


def test_tags_of_another_optimizer_are_refused(tmp_path, one_device_mesh):  # noqa: F811
    _, jparams = _jax_params(LLAMA, seed=5)
    batch = _batches(23, 1, 4)[0]
    built = CausalLM(TransformerConfig(**LLAMA))
    eng_built, _, _, _ = deepspeed_tpu_torch.initialize(
        model=built, model_parameters=params_from_jax(built.config, jparams),
        config=_config(optimizer={"type": "AdamW", "params": {"lr": 1e-3}}), device="cpu")
    eng_built.train_batch(batch)
    eng_built.save_checkpoint(str(tmp_path / "built"))
    client = _port(jparams, PAIRS["sgd"][1])
    client.train_batch(batch)
    client.save_checkpoint(str(tmp_path / "client"))
    jmodel, jp = _jax_params(LLAMA, seed=5)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jp,
                                             optimizer=optax.sgd(1e-2, momentum=0.9),
                                             config=_config(), mesh=one_device_mesh)
    jeng.train_batch(batch)
    jeng.save_checkpoint(str(tmp_path / "jax_client"))

    for src, dst in (("built", _port(jparams, PAIRS["sgd"][1])),
                     ("jax_client", _port(jparams, PAIRS["sgd"][1])),
                     ("client", _port(jparams, PAIRS["adamw"][1])),
                     ("client", eng_built)):
        with pytest.raises(CheckpointCorruptError, match="missing state leaf"):
            dst.load_checkpoint(str(tmp_path / src), tag="global_step1")
    # without the optimizer states, the masters (here the fp32 params) load
    fresh = _port(jparams, PAIRS["adamw"][1])
    fresh.load_checkpoint(str(tmp_path / "built"), tag="global_step1",
                          load_optimizer_states=False)
    for n, p in eng_built.state.params.named_parameters():
        assert torch.equal(p, dict(fresh.state.params.named_parameters())[n]), n
    assert fresh.global_steps == 1 and not fresh.client_optimizer.state


def test_scheduler_warning_surface_and_offload_refusal(monkeypatch):
    _, jparams = _jax_params(LLAMA, seed=4)
    said = []
    monkeypatch.setattr(port_engine.logger, "warning", lambda msg, *a: said.append(msg))
    sched = {"type": "WarmupLR", "params": {"warmup_max_lr": 1e-3, "warmup_num_steps": 2}}
    eng = _port(jparams, PAIRS["sgd"][1], config=_config(scheduler=sched))
    assert any("passed together with a scheduler config" in m for m in said)
    assert eng.get_type() == ["client"] and eng.get_mom() == [None]
    assert eng.optimizer is eng.client_optimizer
    # the engine never multiplies by its own lr: one SGD step moves by lr * g
    before = {n: p.detach().clone() for n, p in eng.state.params.named_parameters()}
    batch = _batches(24, 1, 4)[0]
    eng.train_batch(batch)
    assert eng.get_lr() == [eng._lr_fn(1)]
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in eng.state.params.named_parameters())
    assert 0 < moved <= 1e-2 * 1.0 + 1e-9          # lr x the clipped norm bound
    offload = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
    with pytest.raises(ValueError, match="incompatible with a client"):
        _port(jparams, PAIRS["sgd"][1], config=_config(zero_optimization=offload))
    with pytest.raises(NotImplementedError, match="offload"):
        deepspeed_tpu_torch.initialize(model=CausalLM(TransformerConfig(**LLAMA)),
                                       config=_config(zero_optimization=offload), device="cpu")
