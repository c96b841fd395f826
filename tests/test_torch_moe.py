"""The port's MoE (``deepspeed_tpu_torch/moe``, ``models/moe_lm.py``) against
the JAX package's at expert parallelism 1: the counterparts of
``tests/unit/test_moe.py``'s cases that need no mesh.

Gating: for the same seeded numpy logits, top-1 (positional capacity, a
``used_token`` mask, ``drop_tokens`` off) and top-2 without noise give the
JAX package's ``l_aux``, combine weights, dispatch mask and pre-truncation
expert counts (combine and ``l_aux`` within 1e-6, fp32 softmax sums in
another order; mask and counts equal). The draws (RTS, RSample, Jitter,
top-2's noise) come from a ``torch.Generator``, which cannot share the JAX
key's stream, so they are held by their properties: capacity kept, kept
tokens a subset of the routed ones, a permutation that differs from the
positional one and from another seed's, eval drawing nothing. The ``MoE``
module with its residual blend and an ``MoECausalLM`` (2 layers, 4
experts; top-1, top-2 and residual) against the JAX model from the same
weights (``params_from_jax``): logits and aux within 1e-5, loss and every
leaf's gradient within 3e-5 of its largest value (``tests/test_torch_training.py``);
three engine steps' losses within 1e-5, relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.moe_lm import MoECausalLM as JaxMoELM
from deepspeed_tpu.models.moe_lm import MoEConfig as JaxMoEConfig
from deepspeed_tpu.models.transformer import TransformerConfig as JaxTConfig
from deepspeed_tpu.moe import MoE as JaxMoE
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models.moe_lm import MoECausalLM, MoEConfig
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.moe import (MOELayer, ExpertFFN, MoE, TopKGate, is_moe_param_path,
                                     split_moe_params, top1gating, top2gating)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

GATE_TOL = 1e-6     # combine weights and l_aux, absolute (fp32 softmax sums in another order)
OUT_TOL = 1e-5      # logits, layer outputs and aux, absolute (fp32 products in another order)
LOSS_TOL = 1e-5     # relative
LEAF_TOL = 3e-5     # max |port - jax| over a leaf / max |jax| of the leaf
MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_seq=32, remat=False,
             attention_backend="flash")


def _logits(T, E, seed):
    return np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)


def _same_gating(got, want):
    (l_aux, combine, dispatch, counts), (jl, jc, jd, jn) = got, want
    assert abs(float(l_aux) - float(jl)) <= GATE_TOL
    assert combine.shape == tuple(jc.shape)
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), atol=GATE_TOL, rtol=0)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))


@pytest.mark.parametrize("T,E,cf,min_cap,drop,used", [
    (16, 4, 1.0, 2, True, False),      # capacity 4: tokens dropped
    (8, 2, 2.0, 4, True, False),
    (12, 3, 1.0, 4, False, False),     # drop_tokens off: capacity = tokens
    (32, 4, 0.5, 1, True, True),       # tight, with padding out of the competition
])
def test_top1_gating_matches_jax(T, E, cf, min_cap, drop, used):
    logits = _logits(T, E, T + E)
    mask = (np.arange(T) % 3 != 2).astype(np.float32) if used else None
    want = jsm.top1gating(jnp.asarray(logits), cf, min_cap,
                          None if mask is None else jnp.asarray(mask), None, drop,
                          use_rts=False)
    got = top1gating(torch.from_numpy(logits), cf, min_cap,
                     None if mask is None else torch.from_numpy(mask), None, drop, use_rts=False)
    _same_gating(got, want)
    combine, dispatch = got[1], got[2]
    assert int(dispatch.sum(dim=(1, 2)).max()) <= 1            # one (expert, slot) a token
    assert int(dispatch.int().sum(dim=0).max()) <= 1           # no slot booked twice
    if used:
        assert not dispatch[torch.from_numpy(mask) == 0].any()
    else:
        assert int(got[3].sum()) == T                           # counts before truncation


@pytest.mark.parametrize("T,E,cf,drop", [(16, 4, 2.0, True), (10, 4, 0.5, True),
                                         (12, 3, 1.0, False)])
def test_top2_gating_matches_jax(T, E, cf, drop):
    logits = _logits(T, E, 2 * T + E)
    want = jsm.top2gating(jnp.asarray(logits), cf, 4, drop)
    got = top2gating(torch.from_numpy(logits), cf, 4, drop)
    _same_gating(got, want)
    per_token = got[2].sum(dim=(1, 2))
    both = per_token == 2
    np.testing.assert_allclose(got[1].sum(dim=(1, 2))[both].numpy(), 1.0, atol=1e-5)


def test_balanced_gating_low_aux_loss():
    T, E = 32, 4
    logits = torch.eye(E).repeat(T // E, 1) * 10
    l_aux, _, _, counts = top1gating(logits, capacity_factor=1.0, use_rts=False)
    assert torch.equal(counts, torch.full((E,), T // E, dtype=torch.int32))
    assert abs(float(l_aux) - 1.0) < 0.1


def test_rts_keeps_capacity_and_draws_a_subset():
    """Everyone wants expert 0 at a capacity of 8: RTS keeps 8 tokens as
    positional priority does, a subset of the routed ones, a different
    subset, and another seed's draw differs again; the counts are the
    pre-truncation load either way."""
    T, E = 64, 2
    logits = torch.zeros((T, E))
    logits[:, 0] = 5.0
    kept = lambda d: set(torch.nonzero(d.sum(dim=(1, 2))).flatten().tolist())
    _, _, d_pos, n_pos = top1gating(logits, capacity_factor=0.25, use_rts=False)
    outs = [top1gating(logits, capacity_factor=0.25, use_rts=True,
                       generator=torch.Generator().manual_seed(s)) for s in (7, 8)]
    assert len(kept(d_pos)) == 8 and kept(d_pos) == set(range(8))
    for _, combine, d, n in outs:
        assert len(kept(d)) == 8 and torch.equal(n, n_pos)
        assert int(d.int().sum(dim=0).max()) <= 1
    assert kept(outs[0][2]) != kept(d_pos) and kept(outs[0][2]) != kept(outs[1][2])
    # without a generator RTS falls back to positional priority
    assert torch.equal(top1gating(logits, capacity_factor=0.25, use_rts=True)[2], d_pos)


def test_rsample_routes_on_gumbel_perturbed_logits():
    T, E = 256, 4
    logits = torch.from_numpy(_logits(T, E, 9))
    gen = torch.Generator().manual_seed(1)
    _, _, d, counts = top1gating(logits, capacity_factor=float(E), min_capacity=T,
                                 noisy_gate_policy="RSample", use_rts=False, generator=gen)
    routed = d.sum(dim=2).float().argmax(dim=1)
    assert int(d.sum()) == T and int(counts.sum()) == T
    # the noise moves some tokens off their argmax expert, not most of them
    moved = float((routed != logits.argmax(dim=1)).float().mean())
    assert 0.05 < moved < 0.7
    with pytest.raises(ValueError, match="RSample gating needs a generator"):
        top1gating(logits, noisy_gate_policy="RSample")


def test_top2_noise_picks_another_second_expert():
    T, E = 128, 8
    logits = torch.from_numpy(_logits(T, E, 10))
    plain = top2gating(logits, capacity_factor=float(E), min_capacity=T)
    noisy = top2gating(logits, capacity_factor=float(E), min_capacity=T,
                       generator=torch.Generator().manual_seed(2))
    assert torch.equal(plain[3], noisy[3])                     # first choices unchanged
    assert int(noisy[2].sum()) == 2 * T
    assert not torch.equal(plain[2], noisy[2])


def test_jitter_draws_in_training_only():
    D, E = 8, 4
    gate = TopKGate(D, E, k=1, capacity_factor=4.0, eval_capacity_factor=4.0,
                    noisy_gate_policy="Jitter", use_rts=False)
    plain = TopKGate(D, E, k=1, capacity_factor=4.0, eval_capacity_factor=4.0, use_rts=False)
    params = gate.init(torch.Generator().manual_seed(0))
    x = torch.randn((16, D), generator=torch.Generator().manual_seed(1))
    ev = gate(params, x, generator=torch.Generator().manual_seed(2), train=False)
    want = plain(params, x, train=False)
    assert all(torch.equal(a, b) for a, b in zip(ev, want))
    tr = gate(params, x, generator=torch.Generator().manual_seed(2), train=True)
    again = gate(params, x, generator=torch.Generator().manual_seed(2), train=True)
    assert tr[1].shape[1] == E and all(torch.equal(a, b) for a, b in zip(tr, again))
    # the jitter scales the router input by U(0.99, 1.01): the l_aux moves a little
    assert 0.0 < abs(float(tr[0]) - float(want[0])) < 0.05


def test_moe_layer_single_expert_equals_dense():
    """E = 1 with room for every token: the layer is the expert."""
    D, T = 8, 6
    expert = ExpertFFN(1, D, 16)
    gate = TopKGate(D, 1, k=1, capacity_factor=float(T), min_capacity=T)
    layer = MOELayer(gate, expert.apply)
    gen = torch.Generator().manual_seed(0)
    params = {"gate": gate.init(gen), "experts": expert.init(gen)}
    x = torch.randn((2, 3, D), generator=gen)
    out, _, counts = layer(params, x, train=False)
    one = {k: v[0] for k, v in params["experts"].items()}
    torch.testing.assert_close(out, expert.apply_one(one, x.reshape(-1, D)).reshape(x.shape))
    assert int(counts[0]) == T


def _jax_moe_params(p):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), p)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_module_matches_jax(residual, k):
    """``MoE`` (gate, experts and the PR-MoE blend) on the JAX module's
    weights, eval routing: the same output, l_aux and counts."""
    D = 8
    kw = dict(hidden_size=D, num_experts=4, k=k, capacity_factor=1.0, eval_capacity_factor=1.0,
              use_residual=residual, d_ff=16)
    jm = JaxMoE(**kw)
    jp = jm.init_params(jax.random.key(0))
    x = np.random.default_rng(1).normal(size=(2, 4, D)).astype(np.float32)
    want = jm(jp, jnp.asarray(x), train=False)
    pm = MoE(**kw)
    got = pm(_jax_moe_params(jp), torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=OUT_TOL, rtol=0)
    assert abs(float(got[1]) - float(want[1])) <= GATE_TOL
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    params = pm.init_params(torch.Generator().manual_seed(0))
    assert ("residual_mlp" in params and "coefficient" in params) == residual
    assert {k: tuple(v.shape) for k, v in params["experts"].items()} == \
        {k: tuple(v.shape) for k, v in jp["experts"].items()}


def test_moe_param_classification_and_ep_refusal():
    moe = MoE(hidden_size=8, num_experts=2, d_ff=16)
    params = {"block": {"moe": moe.init_params()}}
    expert, dense = split_moe_params(params)
    assert len(expert) == 4 and len(dense) == 1          # w_up/b_up/w_down/b_down; the gate
    assert is_moe_param_path(("block", "moe", "experts", "w_up"))
    assert not is_moe_param_path("layers.0.mlp.w_up")
    with pytest.raises(NotImplementedError, match="MoE with ep > 1"):
        MoE(hidden_size=8, num_experts=4, ep_size=2)
    with pytest.raises(ValueError, match="divisible"):
        MoE(hidden_size=8, num_experts=3, ep_size=2)


def _pair(k=1, residual=False, seed=0, remat=False, **moe):
    mkw = dict(num_experts=4, k=k, capacity_factor=1.0, eval_capacity_factor=1.0,
               expert_ff_mult=2, use_residual=residual, use_rts=False, **moe)
    model = {**MODEL, "remat": remat}
    jm = JaxMoELM(JaxTConfig(**model), JaxMoEConfig(**mkw))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    pm = MoECausalLM(TransformerConfig(**model), MoEConfig(**mkw))
    return jm, jp, pm, params_from_jax(pm.config, jp)


@pytest.mark.parametrize("k,residual", [(1, False), (2, False), (1, True)])
def test_moe_causal_lm_matches_jax(k, residual):
    """Forward logits and aux (eval and train routing, no draws), the loss
    and every leaf's gradient, from the same weights."""
    jm, jp, pm, pp = _pair(k, residual)
    toks = np.random.default_rng(3).integers(0, 64, size=(2, 16))
    jparams = jax.tree.map(jnp.asarray, jp)
    for train in (False, True):
        jl, ja = jm.forward(jparams, jnp.asarray(toks), train=train)
        pl, pa = pm.forward(pp, torch.from_numpy(toks), train=train)
        np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), atol=OUT_TOL, rtol=0)
        assert abs(float(pa) - float(ja)) <= OUT_TOL
    batch = {"input_ids": toks}
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)))(jparams)
    params = pp.map(lambda t: t, requires_grad=True)
    loss = pm.loss(params, {"input_ids": torch.from_numpy(toks)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    grads = params.map(torch.zeros_like)
    for (_, p), (_, g) in zip(params.named_parameters(), grads.named_parameters()):
        g.data.copy_(p.grad)
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        params_to_jax(pm.config, grads), jax.tree.map(np.asarray, want))
    assert max(jax.tree.leaves(errs)) <= LEAF_TOL, errs
    assert pm.num_parameters == jm.num_parameters


@pytest.mark.parametrize("remat", ["selective", "none"])
def test_any_truthy_remat_is_full_remat(remat):
    """A policy's name, and the string "none", mean full remat in the MoE
    model, as in the JAX one: the loss and every leaf's gradient equal the
    JAX MoECausalLM's under the same setting, and the port's own under
    full remat bit for bit."""
    jm, jp, pm, pp = _pair(remat=remat)
    toks = np.random.default_rng(6).integers(0, 64, size=(2, 16))
    want_loss, want = jax.value_and_grad(lambda p: jm.loss(p, {"input_ids": jnp.asarray(toks)}))(
        jax.tree.map(jnp.asarray, jp))
    runs = []
    for model in (pm, MoECausalLM(dataclasses.replace(pm.config, remat=True), pm.moe)):
        params = pp.map(lambda t: t, requires_grad=True)
        loss = model.loss(params, {"input_ids": torch.from_numpy(toks)})
        loss.backward()
        runs.append((loss.detach(), params))
    loss, params = runs[0]
    assert torch.equal(loss, runs[1][0])
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(params.parameters(),
                                                            runs[1][1].parameters()))
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    grads = params.map(torch.zeros_like)
    for (_, p), (_, g) in zip(params.named_parameters(), grads.named_parameters()):
        g.data.copy_(p.grad)
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        params_to_jax(pm.config, grads), jax.tree.map(np.asarray, want))
    assert max(jax.tree.leaves(errs)) <= LEAF_TOL, errs


def test_routing_draws_repeat_under_remat():
    """RTS and Jitter draw from per-layer generators seeded before each
    layer: with remat the recomputed layers draw the same numbers, so the
    loss and gradients equal those without remat."""
    import dataclasses
    cfg = TransformerConfig(**{**MODEL, "remat": False})
    moe = MoEConfig(num_experts=4, capacity_factor=0.5, expert_ff_mult=2,
                    noisy_gate_policy="Jitter", use_rts=True)
    outs = []
    for remat in (False, True):
        model = MoECausalLM(dataclasses.replace(cfg, remat=remat), moe)
        params = model.init_params(torch.Generator().manual_seed(0)).map(lambda t: t,
                                                                           requires_grad=True)
        toks = torch.from_numpy(np.random.default_rng(4).integers(0, 64, size=(2, 16)))
        loss = model.loss(params, {"input_ids": toks}, rng=torch.Generator().manual_seed(5))
        loss.backward()
        outs.append((loss.detach(), [p.grad for p in params.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.allclose(a, b, atol=1e-6) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.fixture
def one_device_mesh():
    """A one-device mesh with an ep axis of 1 for the JAX engine (its MoE
    specs name ep), restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1, "ep": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def test_engine_steps_match_jax(one_device_mesh):
    """Three train_batch steps of the MoE model (Adam, clipping, gas 2) on
    the port's engine and on the JAX engine: losses within LOSS_TOL, and
    the stacked [E, ...] leaves train (the engine's LR groups, clipping and
    checkpoint take them like any leaf)."""
    jm, jp, pm, pp = _pair(seed=2)
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=jax.tree.map(jnp.asarray, jp),
                                    config=config)[0]
    jm.mesh = jeng.mesh
    peng = deepspeed_tpu_torch.initialize(model=pm, model_parameters=pp, config=config,
                                          device="cpu")[0]
    batch = {"input_ids": np.random.default_rng(6).integers(0, 64, size=(4, 16)).astype(np.int32)}
    losses = []
    for _ in range(3):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want)
        losses.append(got)
    assert losses[-1] < losses[0]
    w0 = dict(pp.named_parameters())["layers.0.mlp.w_up"]
    w = dict(peng.state.params.named_parameters())["layers.0.mlp.w_up"]
    assert w.shape == (4, 32, 64) and not torch.equal(w, w0)
