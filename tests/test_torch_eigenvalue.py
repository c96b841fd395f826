"""The port's MoQ eigenvalue schedule (``deepspeed_tpu_torch/runtime/eigenvalue.py``
and its hooks in ``runtime/quantize.py`` and ``runtime/engine.py``) against
the JAX package's ``deepspeed_tpu/runtime/eigenvalue.py`` on a tiny causal
LM (2 layers, d 32, fp32, plain attention as both packages' HVPs take it).

``_power_iterate`` from one numpy-seeded start vector: each iteration's
eigenvalue within ``ITER_TOL`` relative of the JAX iteration's (the JAX HVP
is forward over reverse, the port's reverse over reverse); the block
restriction of ``compute_eigenvalue`` against the masked iteration over
every leaf, and the mask left out of the HVP reading far from it;
``layer_masks`` and ``post_process``; the engine's eigenvalue schedule
against the JAX engine's over 6 steps (the quantizer's bits and periods
equal, with the mean's distance from a floor(4 x) step asserted and
reported); plain attention inside the HVP; and bf16 params refused as the
JAX engine refuses them. The JAX HVP is jitted here (``jax.jit`` of the
same ``jvp(grad)``), as its eager form takes minutes on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.runtime import eigenvalue as JE
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.runtime import eigenvalue as PE

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

ITER_TOL = 1e-4            # each iteration's eigenvalue, relative
MEAN_TOL = 0.01            # the engines' block means (start vectors differ), absolute
MIN_MARGIN = 0.05          # 4 x mean's distance from an integer where a factor is taken
KW = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=16, remat=False,
          attention_backend="xla")


def _jax_hvp(loss_fn):
    return jax.jit(lambda p, v: jax.jvp(jax.grad(loss_fn), (p,), (v,))[1])


def _setup(seed=0):
    jm = JaxCausalLM(JT.TransformerConfig(**KW))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    pm = CausalLM(TransformerConfig(**KW))
    pp = params_from_jax(pm.config, jp)
    for p in pp.parameters():
        p.requires_grad_(True)
    batch = np.random.default_rng(seed + 1).integers(0, 64, (2, 16)).astype(np.int32)
    return jm, jp, pm, pp, batch


def _v0(jp, seed=5):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: r.standard_normal(a.shape).astype(np.float32), jp)


def _port_iterate(ev, pm, pp, batch, v0_tree, mask, leaves=None, history=None):
    """The port's _power_iterate over ``leaves`` (default: every leaf, the
    mask's zeros projecting the others out)."""
    named = dict(pp.named_parameters())
    v0 = dict(params_from_jax(pm.config, v0_tree).named_parameters())
    names = list(named) if leaves is None else leaves
    loss_fn = lambda p: pm.loss(p, {"input_ids": torch.as_tensor(batch)})
    hvp = ev._hvp_fn(loss_fn, [named[n] for n in names])
    return ev._power_iterate(hvp, pp, [v0[n].detach() for n in names],
                             [mask[n] for n in names], 1.0, history=history)


def test_power_iterate_matches_jax_each_iteration():
    jm, jp, pm, pp, batch = _setup()
    v0 = _v0(jp)
    jparams = jax.tree.map(jnp.asarray, jp)
    jmask = JE.Eigenvalue().layer_masks(jparams, "layers", 2)[1]
    jhvp = _jax_hvp(lambda p: jm.loss(p, {"input_ids": jnp.asarray(batch)}))
    want = []

    def hvp(p, v):          # each iteration's eigenvalue, as _power_iterate forms it
        hv = jhvp(p, v)
        want.append(float(sum(jnp.sum(h * m * x) for h, m, x in zip(
            jax.tree.leaves(hv), jax.tree.leaves(jmask), jax.tree.leaves(v)))))
        return hv
    last, _ = JE.Eigenvalue(max_iter=5, tol=0.0)._power_iterate(
        hvp, jparams, jax.tree.map(jnp.asarray, v0), jmask, 1.0)
    assert len(want) == 5 and abs(want[-1] - last) <= 1e-6 * abs(last)
    ev = PE.Eigenvalue(max_iter=5, tol=0.0)
    mask = ev.layer_masks(pp, "layers", 2)[1]
    history = []
    eig, it = _port_iterate(ev, pm, pp, batch, v0, mask, history=history)
    assert it == 5 and eig == history[-1]
    for k, (g, w) in enumerate(zip(history, want)):
        assert abs(g - w) <= ITER_TOL * abs(w), (k, g, w)
    # the block restriction (the HVP over layer 1's leaves only) is the
    # masked iteration
    block = [n for n, m in mask.items() if m]
    restricted = []
    _port_iterate(ev, pm, pp, batch, v0, mask, leaves=block, history=restricted)
    assert np.allclose(restricted, history, rtol=1e-6, atol=0)
    # planted: the mask not applied to the HVP (the whole Hessian's iteration)
    unmasked = []
    _port_iterate(ev, pm, pp, batch, v0, dict.fromkeys(mask, 1.0), history=unmasked)
    assert abs(unmasked[-1] - history[-1]) > 100 * ITER_TOL * abs(history[-1])


def test_power_iterate_stop_rule_and_scale_match_jax():
    jm, jp, pm, pp, batch = _setup(1)
    v0 = _v0(jp, 6)
    jparams = jax.tree.map(jnp.asarray, jp)
    jmask = JE.Eigenvalue().layer_masks(jparams, "layers", 2)[0]
    hvp = _jax_hvp(lambda p: jm.loss(p, {"input_ids": jnp.asarray(batch)}))
    for scale in (1.0, 4.0):
        jeig, jit_ = JE.Eigenvalue(max_iter=30, tol=1e-2)._power_iterate(
            hvp, jparams, jax.tree.map(jnp.asarray, v0), jmask, scale)
        ev = PE.Eigenvalue(max_iter=30, tol=1e-2)
        mask = ev.layer_masks(pp, "layers", 2)[0]
        named, v = dict(pp.named_parameters()), dict(params_from_jax(pm.config, v0).named_parameters())
        hv = ev._hvp_fn(lambda p: pm.loss(p, {"input_ids": torch.as_tensor(batch)}),
                        list(named.values()))
        eig, it = ev._power_iterate(hv, pp, [v[n].detach() for n in named],
                                    [mask[n] for n in named], scale)
        assert it == jit_ and abs(eig - jeig) <= ITER_TOL * abs(jeig), (scale, it, jit_)


def test_layer_masks_and_post_process_match_jax():
    jm, jp, pm, pp, _ = _setup()
    jmasks = JE.Eigenvalue().layer_masks(jax.tree.map(jnp.asarray, jp), "layers", 3)
    pmasks = PE.Eigenvalue().layer_masks(pp, "layers", 3)
    for jmask, pmask in zip(jmasks, pmasks):
        as_tree = params_to_jax(pm.config, _mask_tree(pm, pmask))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), as_tree, jmask)
    assert not any(pmasks[2].values())                       # past the last layer: empty
    for vals in ([0.5, -2.0, 1.0], [0.0, 3.0], [0.0, 0.0], [], [1e-9, 2e-9]):
        assert PE.Eigenvalue().post_process(list(vals)) == JE.Eigenvalue().post_process(list(vals))


def _mask_tree(pm, mask):
    from deepspeed_tpu_torch.models.transformer import ParamTree
    from deepspeed_tpu_torch.compression.compress import _rebuild
    pp = pm.init_params()
    filled = {n: torch.full_like(t, mask[n]) for n, t in pp.named_parameters()}
    return ParamTree(_rebuild(pp, filled))


def test_compute_eigenvalue_on_an_empty_block_matches_jax(monkeypatch):
    monkeypatch.setattr(JE.Eigenvalue, "_hvp_fn", lambda self, f: _jax_hvp(f))
    jm, jp, pm, pp, batch = _setup()
    jparams = jax.tree.map(jnp.asarray, jp)
    jev, pev = JE.Eigenvalue(max_iter=3), PE.Eigenvalue(max_iter=3)
    jmasks = jev.layer_masks(jparams, "layers", 3)
    pmasks = pev.layer_masks(pp, "layers", 3)
    want = jev.compute_eigenvalue(lambda p: jm.loss(p, {"input_ids": jnp.asarray(batch)}),
                                  jparams, jmasks[2:])
    got = pev.compute_eigenvalue(lambda p: pm.loss(p, {"input_ids": torch.as_tensor(batch)}),
                                 pp, pmasks[2:])
    assert got == want == [1.0] and pev.iterations == [1]


def _ev_config(bf16=False):
    return {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 0,
            "bf16": {"enabled": bf16},
            "quantize_training": {
                "enabled": True, "quantize_bits": {"start_bits": 12, "target_bits": 8},
                "quantize_schedule": {"quantize_period": 1},
                "eigenvalue": {"enabled": True, "max_iter": 100, "tol": 1e-4,
                               "gas_boundary_resolution": 2, "layer_name": "layers",
                               "layer_num": 2}}}


def test_engine_eigenvalue_schedule_matches_jax(monkeypatch):
    """6 steps, the eigenvalues computed at every second step (the gas
    boundary resolution) while a switch is pending: the quantizer's bits and
    periods equal the JAX engine's after every step. The start vectors
    differ (jax.random against a torch generator), so both iterations run to
    convergence and the means agree within MEAN_TOL; where a layer leaf
    switched on a mean, 4 x mean lies at least MIN_MARGIN from an integer,
    so floor(4 x mean) cannot part on that agreement."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    jm, jp, pm, _, batch = _setup(2)
    means = {"jax": [], "port": []}
    real_j, real_p = JE.Eigenvalue.compute_eigenvalue, PE.Eigenvalue.compute_eigenvalue

    def rec(real, key):
        def run(self, *a, **k):
            vals = real(self, *a, **k)
            means[key].append(sum(vals) / len(vals))
            return vals
        return run

    monkeypatch.setattr(JE.Eigenvalue, "compute_eigenvalue", rec(real_j, "jax"))
    monkeypatch.setattr(JE.Eigenvalue, "_hvp_fn", lambda self, f: _jax_hvp(f))
    monkeypatch.setattr(PE.Eigenvalue, "compute_eigenvalue", rec(real_p, "port"))
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    try:
        jeng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=jp,
                                                 config=_ev_config())
        peng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=pm, model_parameters=params_from_jax(pm.config, jp), config=_ev_config(),
            device="cpu")
        switched = []
        for step in range(6):
            before = {k: v["bits"] for k, v in peng.quantizer.state_dict()["leaf_state"].items()}
            jeng.train_batch({"input_ids": batch})
            peng.train_batch({"input_ids": batch})
            after = peng.quantizer.state_dict()["leaf_state"]
            assert after == jeng.quantizer.state_dict()["leaf_state"], step
            if step % 2 == 1 and any(after[k]["bits"] != b for k, b in before.items()
                                     if k.startswith("['layers']")):
                switched.append(len(means["port"]) - 1)
    finally:
        jdist.set_mesh(saved)
    assert len(means["port"]) == len(means["jax"]) == 3
    for j, p in zip(means["jax"], means["port"]):
        assert abs(j - p) <= MEAN_TOL, (j, p)
    margins = [abs(4 * means["port"][i] - round(4 * means["port"][i])) for i in switched]
    print(f"eigenvalue means jax {means['jax']} port {means['port']}; 4 x mean's distance "
          f"from an integer where a layer leaf switched: {margins}")
    assert switched and min(margins) >= MIN_MARGIN
    period = peng.quantizer.state_dict()["leaf_state"]["['layers']['mlp']['w_up']"]["period"]
    assert period == (2 << 1) * (1 + int(4 * means["port"][switched[0]]))


def test_hvp_runs_plain_attention_and_the_plain_ce_head(monkeypatch):
    """Inside the HVP the model runs attention_backend "xla" and the plain
    CE head (the kernels are not twice differentiable): with the model on
    "flash" and fused CE "on", the engine's HVPs never reach the kernel
    wrappers, while its train step does."""
    from deepspeed_tpu_torch.models import transformer as PT
    calls = {"flash": 0, "fused_ce": 0}
    real_fa, real_ce = PT.flash_attention, PT.fused_cross_entropy

    def count(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(PT, "flash_attention", count("flash", real_fa))
    monkeypatch.setattr(PT, "fused_cross_entropy", count("fused_ce", real_ce))
    seen = []
    real = PE.Eigenvalue.compute_eigenvalue

    def during(self, *a, **k):
        before = dict(calls)
        out = real(self, *a, **k)
        seen.append({k2: calls[k2] - before[k2] for k2 in calls})
        return out
    monkeypatch.setattr(PE.Eigenvalue, "compute_eigenvalue", during)
    pm = CausalLM(TransformerConfig(**{**KW, "attention_backend": "flash",
                                       "fused_cross_entropy": "on"}))
    cfg = _ev_config()
    cfg["quantize_training"]["eigenvalue"].update(max_iter=2, gas_boundary_resolution=1)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=pm, config=cfg, device="cpu")
    eng.train_batch({"input_ids": np.random.default_rng(3).integers(0, 64, (2, 16))})
    assert seen == [{"flash": 0, "fused_ce": 0}]
    assert calls == {"flash": 2, "fused_ce": 1}          # the step itself: 2 layers, one head
    assert pm.config.attention_backend == "flash"         # the user's model untouched
    twin = PE.hvp_model(pm)
    assert (twin.config.attention_backend, twin.config.fused_cross_entropy) == ("xla", "off")


def test_bf16_params_are_refused_as_the_jax_engine_refuses_them():
    """The JAX engine's jvp takes fp32 start vectors against the compute
    params: bf16 params raise TypeError there, and in the port."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    jm, jp, pm, _, batch = _setup()
    cfg = _ev_config(bf16=True)
    cfg["quantize_training"]["eigenvalue"].update(max_iter=1, gas_boundary_resolution=1)
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    try:
        jeng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=jp, config=cfg)
        with pytest.raises(TypeError, match="dtype"):
            jeng.train_batch({"input_ids": batch})
    finally:
        jdist.set_mesh(saved)
    peng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=pm, model_parameters=params_from_jax(pm.config, jp), config=cfg, device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        peng.train_batch({"input_ids": batch})
