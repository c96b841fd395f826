"""``init_inference(..., device="cpu") + generate_batch`` in the port against
the JAX engine (``attention_backend="flash"``: its Pallas kernels in
interpret mode), same weights, fp32, greedy, on a Llama-shaped and a
GPT-2-shaped tiny model: mixed prompt lengths, a second call that hits the
prefix cache, prefix caching off, eviction pressure, and n-gram
speculation. Tokens must agree wherever the JAX model's top-2 logit margin
exceeds 1e-3 (an argmax near-tie may flip between two correct
implementations). Settings outside the port's slices raise
(``serving.paged="off"``, the static path, is held to the JAX engine in
``test_torch_generate.py``; speculation in depth in
``test_torch_spec.py``)."""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

MARGIN = 1e-3
SHAPES = {
    "llama": dict(vocab_size=64, max_seq=256, n_layer=2, n_head=2, n_kv_head=1,
                  d_model=128, d_ff=256, pos_embedding="rope", norm="rmsnorm",
                  activation="swiglu", tie_embeddings=False, norm_eps=1e-6),
    "gpt2": dict(vocab_size=64, max_seq=256, n_layer=2, n_head=2, d_model=128,
                 pos_embedding="learned", norm="layernorm", activation="gelu",
                 tie_embeddings=True, attn_bias=True),
}
BASE_SERVING = {"block_size": 128, "max_running": 2}


def _check_tokens(jmodel, jparams, prompts, got, want):
    """Equal, or first differing where the JAX margin is a near-tie."""
    compared = 0
    for p, g, w in zip(prompts, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            compared += g.size - p.size
            continue
        i = int(diff[0])
        logits = np.asarray(jmodel.forward(jparams, w[None, :i]))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < MARGIN, (
            f"tokens differ at {i} where the JAX margin is {top2[1] - top2[0]}")
        compared += i - p.size
    return compared


class _Pair:
    def __init__(self, name):
        kw = SHAPES[name]
        self.jmodel = JaxCausalLM(JT.TransformerConfig(remat=False, attention_backend="flash",
                                                       **kw))
        self.jparams = jax.tree.map(np.asarray, JT.init_params(self.jmodel.config,
                                                               jax.random.key(7)))
        self.pmodel = CausalLM(TransformerConfig(**kw))
        self.params = params_from_jax(self.pmodel.config, self.jparams)

    def engines(self, **serving):
        srv = {**BASE_SERVING, **serving}
        jeng = deepspeed_tpu.init_inference(self.jmodel, params=self.jparams, dtype="fp32",
                                            serving=srv)
        peng = deepspeed_tpu_torch.init_inference(self.pmodel, params=self.params,
                                                  dtype="fp32", device="cpu", serving=srv)
        return jeng, peng

    def serve(self, jeng, peng, prompts, max_new):
        want = jeng.generate_batch(prompts, max_new_tokens=max_new)
        got = peng.generate_batch(prompts, max_new_tokens=max_new)
        n = _check_tokens(self.jmodel, self.jparams, prompts, got, want)
        assert jeng._last_serve_stats == peng._last_serve_stats
        return n


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX engine, so its dispatch takes the bare
    Pallas kernels (interpret mode) as on one chip, instead of the einsum
    fallback the 8-device CPU test mesh would give it. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    jdist.set_mesh(saved)


@pytest.fixture(params=sorted(SHAPES), scope="module")
def pair(request, one_device_mesh):
    return _Pair(request.param)


def _prompts(seed, lengths, vocab=64):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def test_mixed_lengths_then_prefix_cache_hit(pair):
    jeng, peng = pair.engines()
    prompts = _prompts(0, (5, 40, 130))
    assert pair.serve(jeng, peng, prompts, 6) > 0
    assert peng._last_serve_actions.get("prefill") == 3
    # second call: the 130-token prompt's first block is cached, the
    # repeated 40-token prompt is a full-prefix hit with a copy-on-write
    again = [prompts[2][:128].copy(), prompts[1], _prompts(1, (20,))[0]]
    again[0] = np.concatenate([again[0], [1, 2, 3]]).astype(np.int32)
    assert pair.serve(jeng, peng, again, 6) > 0
    assert peng._last_serve_actions.get("prefill_chunk", 0) >= 1


def test_prefix_caching_off(pair):
    jeng, peng = pair.engines(prefix_caching="off")
    prompts = _prompts(2, (17, 9))
    pair.serve(jeng, peng, prompts, 5)
    pair.serve(jeng, peng, prompts, 5)
    assert "prefill_chunk" not in peng._last_serve_actions


def test_eviction_pressure(pair):
    # 3 allocatable blocks for two requests that each grow past one block
    jeng, peng = pair.engines(max_num_blocks=4)
    prompts = _prompts(3, (120, 110))
    pair.serve(jeng, peng, prompts, 20)
    assert peng._last_serve_stats["preemptions"] > 0


@pytest.mark.parametrize("setting,item", [
    ({"mp_size": 2}, "sharded serving"),
    ({"serving": {"tp": 2}}, "sharded serving"),
    ({"tensor_parallel": {"tp_size": 2}}, "sharded serving"),
    ({"moe": {"ep_size": 2}}, "MoE with ep > 1"),
    ({"zero": {"offload_param": {"device": "cpu"}}}, "ZeRO-Inference"),
])
def test_out_of_slice_settings_raise(setting, item):
    """Settings outside the port's slices raise naming their ROADMAP item;
    MoE serves at ep 1 since the MoE slice, so ``moe.ep_size`` is refused
    on an MoE model (on a dense one it is the JAX engine's ValueError,
    tests/test_torch_moe_inference.py). ZeRO-Inference streams a dense
    model since the host-offload slice (tests/test_torch_zero_inference.py);
    an MoE model's streaming is refused as the JAX engine refuses it."""
    model = CausalLM(TransformerConfig(**SHAPES["gpt2"]))
    if "moe" in setting or "zero" in setting:
        from deepspeed_tpu_torch.models.moe_lm import MoECausalLM, MoEConfig
        model = MoECausalLM(model.config, MoEConfig(num_experts=2))
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.init_inference(model, device="cpu", **setting)


@pytest.mark.parametrize("setting", [
    {"serving": {"kv_host": {"enabled": True}}},
    {"serving": {"replicas": {"dp": 2, "roles": ["prefill", "decode"]}}},
])
def test_tier_and_replica_settings_build_an_engine(setting):
    """The tiered KV cache and the replica settings are in the port since
    the router slice: the engine builds, and with the tier its host pool
    has the JAX engine's geometry (``[L, bs, KV, Hd]``, the dtype's name)
    and default cap (four times the pool's allocatable blocks)."""
    model = CausalLM(TransformerConfig(**{**SHAPES["gpt2"], "n_layer": 1}))
    eng = deepspeed_tpu_torch.init_inference(model, device="cpu", dtype="fp32", **setting)
    pool = eng.ensure_host_kv_pool()
    if "kv_host" not in setting["serving"]:
        assert pool is None
        return
    cfg, srv = model.config, eng.config.serving
    n_max = -(-cfg.max_seq // srv.block_size)
    assert pool.block_shape == (cfg.n_layer, srv.block_size, cfg.kv_heads, cfg.head_dim)
    assert pool.dtype == "float32"
    assert pool.max_blocks == 4 * srv.max_running * n_max
    assert eng.ensure_host_kv_pool() is pool


@pytest.mark.parametrize("setting", [
    {"telemetry": {"ctl": {"enabled": True, "cooldown_ticks": 2}}},
    {"telemetry": {"sampler": True}},
    {"telemetry": {"slo": {"enabled": True}}},
    {"telemetry": {"ctl": True}},
    {"telemetry": {"metrics_port": 0}},
])
def test_control_plane_settings_are_accepted_by_the_serving_engine(setting):
    """The JAX serving engine acts on none of ctl, the sampler, the SLOs or
    metrics_port (its async front-end takes them from ``serve``'s flags),
    and neither does the port's: the engine builds and serves the tokens of
    one built without them."""
    model = CausalLM(TransformerConfig(**{**SHAPES["gpt2"], "n_layer": 1}))
    prompts = _prompts(2, (9, 5))
    outs = []
    for over in ({}, setting):
        eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu", **over)
        outs.append(eng.generate_batch(prompts, max_new_tokens=3))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


def test_speculative_decoding_setting_serves(pair):
    """serving.speculative.mode="ngram" serves through generate_batch: the
    same tokens and scheduler stats as the JAX engine with it on, and the
    same tokens as the port with it off."""
    spec = {"speculative": {"mode": "ngram", "k": 3}}
    jeng, peng = pair.engines(**spec)
    r = np.random.default_rng(5)
    prompts = [np.tile(r.integers(0, 64, size=n), 4).astype(np.int32) for n in (3, 7)]
    pair.serve(jeng, peng, prompts, 10)
    assert peng._last_serve_stats["verify_steps"] > 0
    off = deepspeed_tpu_torch.init_inference(pair.pmodel, params=pair.params, dtype="fp32",
                                             device="cpu", serving=BASE_SERVING)
    want = off.generate_batch(prompts, max_new_tokens=10)
    got = peng.generate_batch(prompts, max_new_tokens=10)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_config_fields_aliases_and_unknown_keys():
    c = DeepSpeedInferenceConfig(max_tokens=64, tp={"tp_size": 1}, dtype=torch.bfloat16,
                                 serving={"max_running": "4"})
    assert c.max_out_tokens == 64 and c.tensor_parallel.tp_size == 1
    assert c.dtype.torch is torch.bfloat16 and c.serving.max_running == 4
    assert c.serving.block_size == 128 and c.serving.prefix_caching == "auto"
    assert DeepSpeedInferenceConfig(mp_size=1).tensor_parallel.tp_size == 1
    with pytest.raises(ValueError, match="unknown config key"):
        DeepSpeedInferenceConfig(max_tokenz=3)
    with pytest.raises(ValueError, match="unknown config key"):
        DeepSpeedInferenceConfig(serving={"blocksize": 64})
    # the JAX package's fields, section by section, all present
    from deepspeed_tpu.inference import config as jc
    from deepspeed_tpu_torch.inference import config as pc
    for name in ("DeepSpeedInferenceConfig", "ServingConfig", "SpeculativeConfig",
                 "KvHostConfig", "ReplicaConfig", "ServingFaultConfig"):
        jfields = set(getattr(jc, name).model_fields)
        pfields = {f.name for f in pc.dataclasses.fields(getattr(pc, name))}
        assert jfields == pfields, name


def test_sampling_is_seeded():
    """Temperature / top-k sampling draws from a torch.Generator seeded from
    ``seed``: one seed repeats its tokens, another seed moves them."""
    model = CausalLM(TransformerConfig(**SHAPES["llama"]))
    engine = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                                serving={**BASE_SERVING, "prefix_caching": "off"})
    prompts = _prompts(4, (7, 12))
    kw = dict(max_new_tokens=8, temperature=1.5, top_k=20)
    a = engine.generate_batch(prompts, seed=1, **kw)
    b = engine.generate_batch(prompts, seed=1, **kw)
    c = engine.generate_batch(prompts, seed=2, **kw)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(((x >= 0) & (x < 64)).all() for x in a)
