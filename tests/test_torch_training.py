"""``deepspeed_tpu_torch.initialize(..., device="cpu") + train_batch`` against
the JAX package's ``deepspeed_tpu.initialize`` on a one-device mesh (its
Pallas flash kernels in interpret mode, ``attention_backend="flash"``), same
weights, same batches, fp32, on a tiny Llama (2 layers, d_model 128, 4
heads, 2 kv heads, vocab 256, S 64) with the slice's training config scaled
down: FusedAdam, WarmupLR, clipping 1.0, gas 2. Per-step losses agree
within 1e-5 relative and every parameter leaf within 3e-5 of its largest
value after 3 steps (fp32 sums in other orders, through Adam's normalised
update). Also: the forward/backward/step trio against train_batch, gas 1
against gas 2, the fp16 loss scaler, the lr schedules, the batch triad,
remat, resumption from a JAX state, and the settings the slice refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.core import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.checkpoint.from_jax import (adam_state_from_jax, params_from_jax,
                                                     params_to_jax)
from deepspeed_tpu_torch.config.core import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.runtime import loss_scaler as pls
from deepspeed_tpu_torch.runtime import lr_schedules as plr

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LOSS_TOL = 1e-5     # relative, per step
LEAF_TOL = 3e-5     # max |port - jax| over a leaf / max |jax| of the leaf
LLAMA = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4, n_kv_head=2, d_model=128, d_ff=256,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             norm_eps=1e-6, attention_backend="flash")
GPT2 = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=2, d_model=128, pos_embedding="learned",
            norm="layernorm", activation="gelu", tie_embeddings=True, attn_bias=True,
            attention_backend="flash")


def _config(gas=2, micro=2, **over):
    cfg = {"train_batch_size": gas * micro, "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "FusedAdam",
                         "params": {"lr": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8,
                                    "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4,
                                    "warmup_num_steps": 2}},
           "gradient_clipping": 1.0, "fused_cross_entropy": "off"}
    cfg.update(over)
    return cfg


def _batches(seed, n, rows, S=64, vocab=256):
    r = np.random.default_rng(seed)
    return [{"input_ids": r.integers(0, vocab, size=(rows, S)).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX engine, so its dispatch takes the bare
    Pallas kernels (interpret mode) as on one chip. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def _jax_params(kw, seed=3):
    cfg = JT.TransformerConfig(**kw)
    return JaxCausalLM(cfg), jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(seed)))


def _port(kw, jparams, config, **over):
    model = CausalLM(TransformerConfig(**{**kw, **over}))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(model.config, jparams), config=config,
        device="cpu")
    return engine


def _leaf_errs(cfg, engine, want):
    got = params_to_jax(cfg, engine.state.params)
    return jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()), got,
                        jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("shape", ["llama", "gpt2"])
def test_engine_matches_jax_engine(one_device_mesh, shape):
    kw = {"llama": LLAMA, "gpt2": GPT2}[shape]
    jmodel, jparams = _jax_params(kw)
    config = _config()
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=one_device_mesh)
    peng = _port(kw, jparams, config)
    for step, batch in enumerate(_batches(1, 3, 4)):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
        assert peng.get_lr() == pytest.approx([float(jeng.get_lr()[0])], rel=1e-6)
    assert peng.global_steps == int(jeng.state.global_steps) == 3
    errs = _leaf_errs(peng.module.config, peng, jeng.state.params)
    if "bk" in errs["layers"]["attn"]:
        # the key bias's exact gradient is zero (softmax ignores a shift of
        # a whole row of logits), so Adam normalises rounding noise there:
        # each package moves it by up to lr a step, in its own direction
        bk = errs["layers"]["attn"].pop("bk")
        got = params_to_jax(peng.module.config, peng.state.params)["layers"]["attn"]["bk"]
        assert np.abs(got - np.asarray(jeng.state.params["layers"]["attn"]["bk"])).max() <= \
            2 * sum(peng._lr_fn(s) for s in range(3)), bk
    errs = jax.tree.leaves(errs)
    assert max(errs) <= LEAF_TOL, errs


# The embedding after 3 Adam steps of the fused-CE engines: Adam amplifies
# fp32 rounding in the rows whose micro-step gradients nearly cancel, so
# this leaf moves with the order of the head's sums. The JAX package's own
# fused and plain CE paths leave it 3.5e-5 apart after these 3 steps (llama
# shape), the port's fused path 6.6e-5 from the JAX fused path.
EMBED_ADAM_TOL = 1e-4


@pytest.mark.parametrize("shape", ["llama", "gpt2"])
def test_engine_with_fused_ce_matches_jax_engine(one_device_mesh, shape):
    """``fused_cross_entropy: "on"`` in both packages: the JAX package's K3
    Pallas kernels (interpret mode) against the port's K3 plain version
    (the CPU side of the autograd Function the card runs), GPT-2's tied
    head read as embed.T in place. First the loss gradients at the initial
    weights, every leaf within LEAF_TOL (but the key bias, whose exact
    gradient is zero); then 3 engine steps."""
    kw = {"llama": LLAMA, "gpt2": GPT2}[shape]
    jmodel, jparams = _jax_params(kw, seed=4)
    on = {**kw, "fused_cross_entropy": "on", "remat": False}
    batch = _batches(4, 1, 2)[0]
    jcfg = JT.TransformerConfig(**on)
    want = jax.grad(lambda p: JT.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, jparams))
    cfg = TransformerConfig(**on)
    params = params_from_jax(cfg, jparams).map(lambda t: t, requires_grad=True)
    PT.lm_loss(cfg, params, {k: torch.from_numpy(v).long() for k, v in batch.items()}).backward()
    grads = params.map(torch.zeros_like)
    for (_, p), (_, g) in zip(params.named_parameters(), grads.named_parameters()):
        g.data.copy_(p.grad)
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()),
                        params_to_jax(cfg, grads), jax.tree.map(np.asarray, want))
    errs["layers"]["attn"].pop("bk", None)
    assert max(jax.tree.leaves(errs)) <= LEAF_TOL, errs

    config = _config(fused_cross_entropy="on")
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=one_device_mesh)
    peng = _port(kw, jparams, config)
    assert peng.module.config.fused_cross_entropy == "on"
    for step, batch in enumerate(_batches(11, 3, 4)):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
    errs = _leaf_errs(peng.module.config, peng, jeng.state.params)
    if "bk" in errs["layers"]["attn"]:
        # as in test_engine_matches_jax_engine: rounding noise that Adam
        # normalises, up to lr a step in each package's own direction
        errs["layers"]["attn"].pop("bk")
        got = params_to_jax(peng.module.config, peng.state.params)["layers"]["attn"]["bk"]
        assert np.abs(got - np.asarray(jeng.state.params["layers"]["attn"]["bk"])).max() <= \
            2 * sum(peng._lr_fn(s) for s in range(3))
    assert errs["embed"].pop("tokens") <= EMBED_ADAM_TOL
    assert max(jax.tree.leaves(errs)) <= LEAF_TOL, errs


def test_resume_from_jax_state(one_device_mesh):
    """Two steps in the JAX engine, then params, moments and step count
    carried into the port; step 3 in both lands on the same params."""
    jmodel, jparams = _jax_params(LLAMA, seed=5)
    config = _config()
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=one_device_mesh)
    b1, b2, b3 = _batches(2, 3, 4)
    jeng.train_batch(b1)
    jeng.train_batch(b2)
    cfg = TransformerConfig(**LLAMA)
    opt = jax.tree.map(np.asarray, jeng.state.opt_state)
    state = adam_state_from_jax(cfg, opt)
    assert state.count == 2 and set(state.mu) == set(state.nu)
    peng = _port(LLAMA, jparams, config)           # fresh engine, then the carried state
    peng.load_train_state(params=params_from_jax(cfg, jax.tree.map(np.asarray, jeng.state.params)),
                          opt_state=state, global_steps=int(jeng.state.global_steps))
    want, got = float(jeng.train_batch(b3)), float(peng.train_batch(b3))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    assert max(jax.tree.leaves(_leaf_errs(cfg, peng, jeng.state.params))) <= LEAF_TOL


def test_loss_and_grads_match_jax_lm_loss(one_device_mesh):
    """lm_loss and its gradients, with a key mask and chunked vocab CE."""
    kw = {**LLAMA, "loss_chunk": 64, "remat": False}
    jmodel, jparams = _jax_params(kw)
    r = np.random.default_rng(4)
    batch = {"input_ids": r.integers(0, 256, size=(2, 64)).astype(np.int32),
             "attention_mask": (r.random((2, 64)) > 0.2).astype(np.int32)}
    batch["attention_mask"][:, 0] = 1
    want_loss, want = jax.value_and_grad(
        lambda p: JT.lm_loss(jmodel.config, p, jax.tree.map(jnp.asarray, batch)))(
            jax.tree.map(jnp.asarray, jparams))
    cfg = TransformerConfig(**kw)
    params = params_from_jax(cfg, jparams).map(lambda t: t, requires_grad=True)
    loss = PT.lm_loss(cfg, params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    grad_tree = params.map(torch.zeros_like)
    for (_, p), (_, g) in zip(params.named_parameters(), grad_tree.named_parameters()):
        g.data.copy_(p.grad)
    grads = params_to_jax(cfg, grad_tree)
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()), grads,
                        jax.tree.map(np.asarray, want))
    assert max(jax.tree.leaves(errs)) <= LEAF_TOL, errs


def test_trio_equals_train_batch():
    _, jparams = _jax_params(LLAMA)
    a = _port(LLAMA, jparams, _config())
    b = _port(LLAMA, jparams, _config())
    for batch in _batches(6, 2, 4):
        want = a.train_batch(batch)
        losses = []
        for i in range(2):
            micro = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
            loss = b(micro)
            b.backward(loss)
            losses.append(float(loss.detach()))
            b.step()
            assert b.is_gradient_accumulation_boundary() == (i == 1)
        assert float(want) == pytest.approx(np.mean(losses), rel=1e-6)
    assert b.global_steps == a.global_steps == 2 and b.was_step_applied()
    for (n, p), (_, q) in zip(a.state.params.named_parameters(),
                              b.state.params.named_parameters()):
        assert torch.equal(p, q), n


def test_gas1_matches_gas2_on_the_same_global_batch():
    _, jparams = _jax_params(LLAMA)
    one = _port(LLAMA, jparams, _config(gas=1, micro=4))
    two = _port(LLAMA, jparams, _config(gas=2, micro=2))
    assert one.state.acc_grads is None and two.state.acc_grads is not None
    for batch in _batches(7, 3, 4):
        assert float(one.train_batch(batch)) == pytest.approx(float(two.train_batch(batch)),
                                                               rel=1e-5)
    for (n, p), (_, q) in zip(one.state.params.named_parameters(),
                              two.state.params.named_parameters()):
        p, q = p.detach(), q.detach()
        assert float((p - q).abs().max()) <= LEAF_TOL * float(q.abs().max()), n


def test_remat_gives_the_same_grads():
    _, jparams = _jax_params(LLAMA)
    grads = []
    for remat in (True, False):
        cfg = TransformerConfig(**{**LLAMA, "remat": remat})
        params = params_from_jax(cfg, jparams).map(lambda t: t, requires_grad=True)
        PT.lm_loss(cfg, params, {"input_ids": torch.from_numpy(
            _batches(8, 1, 2)[0]["input_ids"]).long()}).backward()
        grads.append([p.grad for p in params.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


def _fp16_boost_loss(model):
    """A loss callable whose batch carries a per-row factor: a huge factor
    makes the fp16 grads overflow on the step it is fed."""
    def loss(params, batch, rng=None):
        return model.loss(params, {"input_ids": batch["input_ids"]}, rng) * batch["boost"][0]
    return loss


def test_fp16_dynamic_loss_scale_under_injected_overflow():
    """The port's fp16 engine skips the overflowing step (params and
    moments untouched), and its scaler follows the JAX package's pure
    transition over the same overflow sequence."""
    _, jparams = _jax_params(LLAMA)
    model = CausalLM(TransformerConfig(**LLAMA))
    fp16 = {"enabled": True, "initial_scale_power": 4, "loss_scale_window": 2, "hysteresis": 2}
    eng = deepspeed_tpu_torch.initialize(
        model=_fp16_boost_loss(model), model_parameters=params_from_jax(model.config, jparams),
        config=_config(fp16=fp16, scheduler=None), device="cpu")[0]
    assert eng.state.params["embed"]["tokens"].dtype == torch.float16
    overflow_at = {1, 3, 4}
    jstate = jls.make_loss_scale_state(init_scale=16.0, scale_window=2, min_scale=1.0,
                                       delayed_shift=2)
    for step, batch in enumerate(_batches(9, 6, 4)):
        batch["boost"] = np.full((4,), 1e30 if step in overflow_at else 1.0, np.float32)
        before = [p.detach().clone() for p in eng.state.params.parameters()]
        count = eng.state.opt_state.count
        eng.train_batch(batch)
        applied = step not in overflow_at
        assert eng.was_step_applied() == applied
        assert eng.state.opt_state.count == count + applied
        same = all(torch.equal(a, p) for a, p in zip(before, eng.state.params.parameters()))
        assert same != applied
        jstate = jls.update(jstate, jnp.asarray(not applied))
        assert (eng.loss_scale, eng.state.scaler.good_steps, eng.state.scaler.hysteresis) == (
            float(jstate.loss_scale), int(jstate.good_steps), int(jstate.hysteresis))
    assert eng.skipped_steps == len(overflow_at)


@pytest.mark.parametrize("seq", [[False] * 5, [True, False, True, True, False, False, False],
                                 [False, True, False, False, True, True, True, False]])
def test_loss_scaler_transitions_match_jax(seq):
    kw = dict(init_scale=2.0**8, scale_window=3, min_scale=2.0, delayed_shift=2)
    j, p = jls.make_loss_scale_state(**kw), pls.make_loss_scale_state(**kw)
    for overflow in seq:
        j, p = jls.update(j, jnp.asarray(overflow)), pls.update(p, overflow)
        assert (p.loss_scale, p.good_steps, p.hysteresis) == (
            float(j.loss_scale), int(j.good_steps), int(j.hysteresis))
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert bool(pls.has_overflow(grads)) and not bool(pls.has_overflow(grads[:1]))


SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=3e-4, warmup_num_steps=20),
    "WarmupLR_linear": dict(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=7,
                            warmup_type="linear"),
    "WarmupDecayLR": dict(total_num_steps=100, warmup_min_lr=0.0, warmup_max_lr=1e-3,
                          warmup_num_steps=10),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3, cycle_first_step_size=10,
                     decay_step_size=5, decay_lr_rate=0.1),
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=10,
                        lr_range_test_step_rate=2.0, lr_range_test_staircase=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    params = SCHEDULES[name]
    kind = name.split("_")[0]
    jfn, pfn = jlr.get_lr_schedule_fn(kind, params), plr.get_lr_schedule_fn(kind, params)
    for step in (0, 1, 2, 5, 9, 10, 11, 19, 20, 23, 40, 99, 100, 150):
        want = float(jfn(jnp.int32(step)))
        assert pfn(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step
    sched = getattr(plr, kind)(**params)
    sched.step()
    sched.step()
    assert sched.get_lr() == pytest.approx([float(jfn(jnp.int32(1)))], rel=1e-6)


TRIADS = [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 8, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 5},
    {"train_batch_size": 6},
    {"train_micro_batch_size_per_gpu": 7},
]
BAD_TRIADS = [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 2},
    {"train_batch_size": 0},
    {"gradient_accumulation_steps": 2},
]


@pytest.mark.parametrize("i", range(len(TRIADS)))
def test_batch_triad_matches_jax(i):
    want, got = JaxConfig(TRIADS[i], world_size=1), DeepSpeedConfig(TRIADS[i])
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "gradient_accumulation_steps"):
        assert getattr(got, key) == getattr(want, key)


@pytest.mark.parametrize("i", range(len(BAD_TRIADS)))
def test_bad_batch_triad_raises_in_both(i):
    with pytest.raises((AssertionError, Exception)):
        JaxConfig(BAD_TRIADS[i], world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(BAD_TRIADS[i])


def test_config_fields_match_jax():
    cfg = _config(bf16={"enabled": True}, zero_optimization={"stage": 2},
                  data_types={"grad_accum_dtype": "fp32"}, steps_per_print=5)
    want, got = JaxConfig(cfg, world_size=1), DeepSpeedConfig(cfg)
    for key in ("optimizer_name", "optimizer_params", "scheduler_name", "scheduler_params",
                "gradient_clipping", "bfloat16_enabled", "fp16_enabled",
                "zero_optimization_stage", "gradient_accumulation_dtype", "fused_cross_entropy",
                "steps_per_print"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("over,match", [
    ({"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}, "offload"),
    ({"optimizer": {"type": "OneBitAdam", "params": {}}}, "onebit"),
    ({"optimizer": {"type": "onebitlamb", "params": {}}}, "lamb"),
    ({"quantize_training": {"enabled": True, "eigenvalue": {"enabled": True}}}, "eigenvalue"),
    ({"pipeline": {"stages": 2}}, "runtime/pipe"),
    ({"mesh": {"dp": 1, "sp": 2}}, "multi-device"),
    ({"compression_training": {"weight_quantization": {}}}, "compression"),
    ({"comms_logger": {"enabled": True}}, "comm/"),
    ({"checkpoint": {"engine": "orbax"}}, "checkpoint"),
    ({"elasticity": {"enabled": True}}, "elasticity"),
    ({"autotuning": {"enabled": True}}, "autotuning"),
])
def test_outside_the_slice_raises_naming_its_item(over, match):
    _, jparams = _jax_params(LLAMA)
    with pytest.raises(NotImplementedError, match=match):
        _port(LLAMA, jparams, _config(**over)).train_batch(_batches(0, 1, 4)[0])


@pytest.mark.parametrize("section", [
    {"comet": {"enabled": True, "project": "p", "experiment_name": "e"}},
    {"telemetry": {"ctl": {"enabled": True}}},
    {"telemetry": {"enabled": True, "ctl": {"enabled": True, "cooldown_ticks": 1}}},
])
def test_sections_without_effect_on_training_are_accepted(section):
    """``comet`` (the JAX package has no comet sink and its config ignores
    the key) and ``telemetry.ctl`` (the JAX training engine does not act on
    it; the controller lives beside the async serving loop): an engine
    built with the section trains bit-equal to one built without."""
    _, jparams = _jax_params(LLAMA)
    batches = _batches(0, 2, 4)
    losses = []
    for over in ({}, section):
        engine = _port(LLAMA, jparams, _config(**over))
        losses.append([float(engine.train_batch(b)) for b in batches])
        engine.destroy()
    assert losses[0] == losses[1]


def test_engine_refusals():
    model = CausalLM(TransformerConfig(**LLAMA))
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        deepspeed_tpu_torch.initialize(model=model, optimizer=object(), config=_config(),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint ingestion"):
        deepspeed_tpu_torch.initialize(model=model, config=_config(nebula={"enabled": True}),
                                       device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="unknown config key"):
        deepspeed_tpu_torch.initialize(model=model, config=_config(train_batchsize=3),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        cfg = TransformerConfig(**{**LLAMA, "remat": "selective"})
        PT.lm_loss(cfg, params_from_jax(cfg, _jax_params(LLAMA)[1]),
                   {"input_ids": torch.zeros((1, 8), dtype=torch.long)})
    engine = deepspeed_tpu_torch.initialize(model=model, config=_config(), device="cpu")[0]
    with pytest.raises(ValueError, match="leading dim"):
        engine.train_batch(_batches(0, 1, 3)[0])
    with pytest.raises(ValueError, match="needs a batch, a data_iter, or engine training_data"):
        engine.train_batch()
