"""MoE serving in the port at expert parallelism 1 against the JAX engine's:
the counterparts of ``tests/unit/test_moe_inference.py``'s ep-1 cases.

An ``MoECausalLM`` (2 layers, 4 experts) with the same weights on both
sides (``params_from_jax``), fp32, the JAX engine without a mesh: the
cached decode against the full forward (within ``TOL``), ``generate``
against greedy recompute on the same engine and against the JAX engine's
tokens (standard, residual, and int8 weights with q_groups 8, also residual
and with an untied head: equal wherever the JAX model's top-2 logit margin
exceeds ``MARGIN``, the rule of ``tests/test_torch_serving.py``; int8
logits within ``LOGIT_ULPS`` bf16 ulps of the JAX int8 engine's),
``generate_batch`` on the static path, bucket padding that cannot steal
expert capacity, the config and engine errors (an unknown ``moe.type``,
the type / model mismatch both ways, ``ep_size`` on a dense model, ep not
dividing the experts, ``ep_size`` > 1 naming "MoE with ep > 1", weight
streaming), and the Megatron-DeepSpeed standard and residual MoE keys
(bit-equal trees, the mixed-stacking error)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jdist
import deepspeed_tpu_torch
from deepspeed_tpu.models.moe_lm import MoECausalLM as JaxMoELM
from deepspeed_tpu.models.moe_lm import MoEConfig as JaxMoEConfig
from deepspeed_tpu.models.transformer import TransformerConfig as JaxTConfig
from deepspeed_tpu.module_inject.megatron import map_megatron_params as jax_map
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models.moe_lm import MoECausalLM, MoEConfig
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.module_inject.megatron import map_megatron_params
from deepspeed_tpu_torch.ops.quant import Quantized8
from tests.unit import test_moe_inference as jax_moe_tests

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TOL = 2e-4          # fp32 logits, absolute: the JAX test's cached-vs-full bound
MARGIN = 1e-3       # tests/test_torch_serving.py: a token may differ only at a near-tie
LOGIT_ULPS = 2.0    # int8 (bf16 compute): bf16 ulps of a row's largest |JAX logit|
MODEL = dict(vocab_size=128, n_layer=2, n_head=4, d_model=32, d_ff=64, max_seq=256,
             remat=False)


@pytest.fixture(autouse=True)
def no_mesh():
    jdist.set_mesh(None)
    yield
    jdist.set_mesh(None)


def _pair(residual=False, seed=0, model=None, **moe):
    mkw = dict(num_experts=4, capacity_factor=2.0, eval_capacity_factor=4.0, min_capacity=8,
               expert_ff_mult=2, use_residual=residual)
    mkw.update(moe)
    kw = {**MODEL, **(model or {})}
    jm = JaxMoELM(JaxTConfig(**kw), JaxMoEConfig(**mkw))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    pm = MoECausalLM(TransformerConfig(**kw), MoEConfig(**mkw))
    return jm, jp, pm, params_from_jax(pm.config, jp)


def _moe_cfg(residual):
    return {"moe": {"type": "residual"}} if residual else {}


def _same_tokens(jm, jp, prompt, got, want):
    """Equal, or first differing where the JAX model's margin is a near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        diff = np.nonzero(g != w)[0]
        if diff.size:
            i = int(diff[0])
            logits, _ = jm.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(w[None, :i]),
                                   train=False)
            top2 = np.sort(np.asarray(logits)[0, -1])[-2:]
            assert top2[1] - top2[0] < MARGIN, f"tokens differ at {i} off a near-tie"


def test_cached_decode_matches_the_full_forward():
    jm, jp, pm, pp = _pair()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 128, size=(2, 8)))
    full, _ = pm.forward(pp, toks, train=False)
    cache = pm.init_cache(2, 32, dtype=torch.float32)
    got, cache = pm.forward_cached(pp, toks, cache, 0)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL, rtol=0)
    jfull, _ = jm.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks.numpy()), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfull), atol=TOL, rtol=0)
    nxt = torch.tensor([[7], [9]])
    got2, _ = pm.forward_cached(pp, nxt, cache, 8)
    full2, _ = pm.forward(pp, torch.cat([toks, nxt], dim=1), train=False)
    np.testing.assert_allclose(got2[:, 0].numpy(), full2[:, 8].numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("residual", [False, True])
def test_generate_matches_recompute_and_the_jax_engine(residual):
    jm, jp, pm, pp = _pair(residual, seed=2)
    eng = deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu",
                                             **_moe_cfg(residual))
    prompt = np.asarray([[5, 9, 2]], np.int32)
    out = eng.generate(prompt, max_new_tokens=5)
    assert out.shape == (1, 8)
    toks = torch.from_numpy(prompt).long()
    for _ in range(5):                        # greedy full-prefix recompute, same engine
        nxt = eng.forward(toks.numpy())[:, -1].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out, toks.numpy())
    jeng = deepspeed_tpu.init_inference(jm, params=jp, config={"dtype": "fp32",
                                                                **_moe_cfg(residual)})
    _same_tokens(jm, jp, prompt, out, jeng.generate(prompt, max_new_tokens=5))
    np.testing.assert_allclose(eng.forward(out).numpy(), np.asarray(jeng.forward(out)),
                               atol=TOL, rtol=0)


def test_generate_batch_takes_the_static_path():
    """An MoE model does not page (the JAX engine's _paged_supported):
    generate_batch serves each prompt through generate; paged "on" raises
    the JAX engine's ValueError."""
    jm, jp, pm, pp = _pair(seed=3)
    eng = deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu")
    prompts = [np.asarray([3, 4, 5], np.int32), np.asarray([8, 1, 2, 6, 7], np.int32)]
    rows = eng.generate_batch(prompts, max_new_tokens=4)
    for p, r in zip(prompts, rows):
        np.testing.assert_array_equal(r, eng.generate(p[None], max_new_tokens=4)[0])
    assert not eng._paged_supported() and eng._last_serve_actions == {}
    on = deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu",
                                            serving={"paged": "on"})
    with pytest.raises(ValueError, match="cannot page"):
        on.generate_batch(prompts, max_new_tokens=2)


def test_prefill_padding_cannot_steal_capacity():
    """At tight eval capacity (about 1.05 x the fair share, min 1) the
    first generated token of a short prompt (right-padded to a 128 bucket)
    equals the unpadded full forward's argmax in both packages."""
    jm, jp, pm, pp = _pair(seed=4, capacity_factor=1.0, eval_capacity_factor=1.05,
                           min_capacity=1)
    prompt = np.asarray([[5, 9, 2], [11, 4, 7]], np.int32)
    out = deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu"
                                             ).generate(prompt, max_new_tokens=1)
    logits, _ = pm.forward(pp, torch.from_numpy(prompt), train=False)
    np.testing.assert_array_equal(out[:, 3], logits[:, -1].argmax(-1).numpy())
    jout = deepspeed_tpu.init_inference(jm, params=jp, config={"dtype": "fp32"}).generate(
        prompt, max_new_tokens=1)
    np.testing.assert_array_equal(out, np.asarray(jout))


def _ulps(got, want):
    """Largest |got - want| of each row in bf16 ulps of the row's largest |want|."""
    want = np.asarray(want, np.float64)
    diff = np.abs(np.asarray(got, np.float64) - want).max(-1)
    return float((diff / np.exp2(np.floor(np.log2(np.abs(want).max(-1))) - 7)).max())


@pytest.mark.parametrize("residual,tied", [(False, True), (True, True), (False, False)])
def test_int8_moe_matches_the_jax_int8_engine(residual, tied):
    """dtype int8 with q_groups 8: the expert (and PR-MoE branch, and untied
    head) weights rest as Quantized8 leaves, q and scales bit-equal to the
    JAX engine's; forward logits within LOGIT_ULPS; generate tokens by the
    near-tie rule."""
    jm, jp, pm, pp = _pair(residual, seed=5, model={"tie_embeddings": tied})
    cfg = {"dtype": "int8", "quant": {"weight": {"q_groups": 8}}, **_moe_cfg(residual)}
    eng = deepspeed_tpu_torch.init_inference(pm, params=pp, device="cpu", **cfg)
    jeng = deepspeed_tpu.init_inference(jm, params=jp, config=cfg)
    mlp = eng.params["layers"][0]["mlp"]
    assert isinstance(mlp["w_up"], Quantized8) and tuple(mlp["w_up"].shape) == (4, 32, 64)
    assert isinstance(mlp.get("res_w_up"), Quantized8) == residual
    assert isinstance(eng.params.get("lm_head"), Quantized8) == (not tied)
    want = params_from_jax(pm.config, jax.tree.map(np.asarray, jeng.params))
    for (n, a), (m, b) in zip(eng.params.named_parameters(), want.named_parameters()):
        if n.endswith((".q", ".scale")):
            assert n == m and torch.equal(a, b.to(a.dtype)), n
    toks = np.random.default_rng(6).integers(0, 128, size=(2, 24)).astype(np.int32)
    got = eng.forward(toks).float().numpy()
    assert _ulps(got, np.asarray(jeng.forward(toks), np.float32)) <= LOGIT_ULPS
    prompt = np.asarray([[3, 1, 4]], np.int32)
    out = eng.generate(prompt, max_new_tokens=3)
    assert out.shape == (1, 6)
    jq = jax.tree.map(np.asarray, jeng.params)
    _same_tokens(jm, jq, prompt, out, jeng.generate(prompt, max_new_tokens=3))


def test_moe_trees_cross_both_ways_with_int8_experts():
    """params_to_jax(params_from_jax(tree)) gives the JAX tree back, the
    stacked [L, E, ...] expert leaves and the PR-MoE leaves included, and an
    int8 tree's Quantized8 expert leaves too."""
    from deepspeed_tpu.ops.quant import quantize_params
    jm, jp, pm, pp = _pair(True, seed=7)
    back = params_to_jax(pm.config, pp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    jq = jax.tree.map(np.asarray, quantize_params(jax.tree.map(jnp.asarray, jp), groups=8))
    pq = params_from_jax(pm.config, jq)
    assert isinstance(pq["layers"][1]["mlp"]["w_down"], Quantized8)
    assert tuple(pq["layers"][1]["mlp"]["w_down"].scale.shape) == (4, 64, 8)
    qback = params_to_jax(pm.config, pq)
    assert np.array_equal(qback["layers"]["mlp"]["w_up"].q, np.asarray(jq["layers"]["mlp"]["w_up"].q))
    assert np.array_equal(qback["layers"]["mlp"]["res_w_down"].scale,
                          np.asarray(jq["layers"]["mlp"]["res_w_down"].scale))


def test_moe_type_errors():
    residual = _pair(True, seed=8)
    standard = _pair(False, seed=8)
    with pytest.raises(ValueError, match="IS a residual"):
        deepspeed_tpu_torch.init_inference(residual[2], params=residual[3], dtype="fp32",
                                           device="cpu")
    with pytest.raises(ValueError, match="is NOT a residual"):
        deepspeed_tpu_torch.init_inference(standard[2], params=standard[3], dtype="fp32",
                                           device="cpu", moe={"type": "residual"})
    for cfg in ({"moe": {"type": "bogus"}}, {"moe_type": "bogus"}):
        with pytest.raises(ValueError, match="moe.type"):
            deepspeed_tpu_torch.init_inference(standard[2], params=standard[3], device="cpu",
                                               **cfg)


def test_ep_size_errors():
    from deepspeed_tpu_torch.models import CausalLM
    dense = CausalLM(TransformerConfig(vocab_size=64, n_layer=1, n_head=2, d_model=32,
                                       max_seq=16, remat=False))
    with pytest.raises(ValueError, match="no MoE layers"):
        deepspeed_tpu_torch.init_inference(dense, device="cpu", moe={"ep_size": 2})
    jm, jp, pm, pp = _pair(seed=9)
    with pytest.raises(ValueError, match="divide"):
        deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu",
                                           moe={"ep_size": 8})
    with pytest.raises(NotImplementedError, match="MoE with ep > 1"):
        deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu",
                                           moe={"ep_size": 2})
    with pytest.raises(NotImplementedError, match="weight streaming of MoE"):
        deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu",
                                           zero={"offload_param": {"device": "cpu"}})


MEGATRON = dict(vocab_size=96, n_layer=2, n_head=4, d_model=32, max_seq=16, attn_bias=True,
                remat=False)


def _megatron(residual, seed):
    jm = JaxMoELM(JaxTConfig(**MEGATRON), JaxMoEConfig(num_experts=3, expert_ff_mult=2,
                                                       use_residual=residual))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    sd = jax_moe_tests.TestMegatronMoEIngestion()._fake_sd(jm, jp)
    if residual:        # the residual naming: experts under mlp.moe, the dense branch, coef
        sd = {k.replace(".mlp.deepspeed_moe.", ".mlp.moe.deepspeed_moe."): v
              for k, v in sd.items()}
        lay = jp["layers"]["mlp"]
        for i in range(2):
            pre = f"transformer.layers.{i}.mlp"
            sd[f"{pre}.mlp.dense_h_to_4h.weight"] = lay["res_w_up"][i].T
            sd[f"{pre}.mlp.dense_h_to_4h.bias"] = lay["res_b_up"][i]
            sd[f"{pre}.mlp.dense_4h_to_h.weight"] = lay["res_w_down"][i].T
            sd[f"{pre}.mlp.dense_4h_to_h.bias"] = lay["res_b_down"][i]
            sd[f"{pre}.coefficient.weight"] = lay["coef_w"][i].T
            sd[f"{pre}.coefficient.bias"] = lay["coef_b"][i]
    return jm, jp, sd


@pytest.mark.parametrize("residual", [False, True])
def test_megatron_moe_keys_round_trip(residual):
    """Megatron-DeepSpeed MoE keys (standard under mlp.deepspeed_moe,
    residual under mlp.moe.deepspeed_moe with mlp.mlp and mlp.coefficient)
    map to the zoo tree bit for bit, as the JAX loader's do, and serve the
    original weights' logits."""
    jm, jp, sd = _megatron(residual, 10 + residual)
    cfg = TransformerConfig(**MEGATRON)
    mapped = map_megatron_params({k: torch.from_numpy(np.array(v))
                                  for k, v in sd.items()}, cfg, version=0)
    want = params_from_jax(cfg, jp)
    got = dict(deepspeed_tpu_torch.models.ParamTree(mapped).named_parameters())
    for name, w in want.named_parameters():
        if name in got:
            assert torch.equal(got[name], w), name
    for key in ("gate_w", "w_up", "b_down") + (("res_w_up", "coef_w", "coef_b") if residual
                                                else ()):
        assert torch.equal(got[f"layers.1.mlp.{key}"], dict(want.named_parameters())[
            f"layers.1.mlp.{key}"]), key
    jmapped = jax_map(sd, jm.config, version=0)
    np.testing.assert_array_equal(np.asarray(jmapped["layers"]["mlp"]["w_up"]),
                                  np.stack([t["mlp"]["w_up"].numpy() for t in mapped["layers"]]))


def test_mixed_dense_moe_stacking_raises():
    jm, jp, sd = _megatron(False, 13)
    sd = {k: v for k, v in sd.items() if "layers.1.mlp.deepspeed_moe.experts" not in k}
    with pytest.raises(NotImplementedError, match="mixed dense/MoE"):
        jax_map(sd, jm.config, version=0)
    with pytest.raises(NotImplementedError, match="mixed dense/MoE"):
        map_megatron_params({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                            TransformerConfig(**MEGATRON), version=0)
