"""Static generation in the port (``InferenceEngine.generate`` over the dense
KV workspace, ``forward_cached``, the dense decode kernel's plain version on
the CPU) against the JAX engine's ``generate`` on a one-device mesh with
``attention_backend="flash"`` (its K5 Pallas kernel in interpret mode), same
weights (``params_from_jax``), fp32, on a Llama-shaped and a GPT-2-shaped
tiny model.

Greedy tokens must agree wherever the JAX model's top-2 logit margin
exceeds 1e-3 (an argmax near-tie may flip between two correct
implementations); ``forward_cached`` logits and caches, and ``forward``
logits, agree at 1e-4. Also: the workspace growing and a smaller batch
running on a slice of it, eos early stop, the max_seq check,
``generate_batch`` with ``serving.paged="off"``, seeded sampling, and the
streaming branch of the cached attention at a patched tiny threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

MARGIN = 1e-3
TOL = 1e-4
SHAPES = {
    "llama": dict(vocab_size=64, max_seq=256, n_layer=2, n_head=2, n_kv_head=1,
                  d_model=128, d_ff=256, pos_embedding="rope", norm="rmsnorm",
                  activation="swiglu", tie_embeddings=False, norm_eps=1e-6),
    "gpt2": dict(vocab_size=64, max_seq=256, n_layer=2, n_head=2, d_model=128,
                 pos_embedding="learned", norm="layernorm", activation="gelu",
                 tie_embeddings=True, attn_bias=True),
}


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX engine, so its dispatch takes the bare
    Pallas kernels (interpret mode) as on one chip. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    jdist.set_mesh(saved)


class _Pair:
    def __init__(self, name):
        kw = SHAPES[name]
        self.jcfg = JT.TransformerConfig(remat=False, attention_backend="flash", **kw)
        self.jmodel = JaxCausalLM(self.jcfg)
        self.jparams = jax.tree.map(np.asarray, JT.init_params(self.jcfg, jax.random.key(11)))
        self.pmodel = CausalLM(TransformerConfig(**kw))
        self.params = params_from_jax(self.pmodel.config, self.jparams)

    def engines(self, **cfg):
        jeng = deepspeed_tpu.init_inference(self.jmodel, params=self.jparams, dtype="fp32",
                                            **cfg)
        peng = deepspeed_tpu_torch.init_inference(self.pmodel, params=self.params,
                                                  dtype="fp32", device="cpu", **cfg)
        return jeng, peng

    def check_tokens(self, prompt_len, got, want):
        """Equal rows, or a first difference where the JAX margin is a
        near-tie. Returns the number of new tokens compared."""
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        compared = 0
        for g, w in zip(got, want):
            diff = np.nonzero(g != w)[0]
            if diff.size == 0:
                compared += g.size - prompt_len
                continue
            i = int(diff[0])
            logits = np.asarray(self.jmodel.forward(self.jparams, w[None, :i]))[0, -1]
            top2 = np.sort(logits)[-2:]
            margin = top2[1] - top2[0]
            assert margin < MARGIN, f"tokens differ at {i} where the JAX margin is {margin}"
            compared += i - prompt_len
        return compared


@pytest.fixture(params=sorted(SHAPES), scope="module")
def pair(request, one_device_mesh):
    return _Pair(request.param)


def _prompts(seed, B, n, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


def test_greedy_tokens_match_jax(pair):
    jeng, peng = pair.engines()
    ids = _prompts(0, 2, 20)
    want = jeng.generate(ids, max_new_tokens=12)
    got = peng.generate(ids, max_new_tokens=12)
    assert got.dtype == np.int32 and got.shape == (2, 32)
    assert np.array_equal(got[:, :20], ids)
    assert pair.check_tokens(20, got, want) > 0


def test_forward_cached_logits_and_caches_match_jax(pair):
    """A 128-bucket prefill at pos 0, then one decode step with a pad bias
    through the decode kernel (the JAX one interpreted)."""
    r = np.random.default_rng(1)
    jcfg, pcfg = pair.jcfg, pair.pmodel.config
    toks = r.integers(0, 64, size=(2, 128)).astype(np.int32)
    jcache = JT.init_kv_cache(jcfg, 2, 256, dtype=jnp.float32)
    pcache = PT.init_kv_cache(pcfg, 2, 256, dtype=torch.float32)
    assert tuple(pcache["k"].shape) == tuple(jcache["k"].shape)
    jl, jcache = JT.forward_cached(jcfg, pair.jparams, jnp.asarray(toks), jcache, jnp.int32(0))
    pl, pcache = PT.forward_cached(pcfg, pair.params, torch.from_numpy(toks).long(), pcache, 0)
    for got, want, what in ((pl, jl, "prefill logits"), (pcache["k"], jcache["k"], "k"),
                            (pcache["v"], jcache["v"], "v")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0,
                                   err_msg=what)
    pad = np.where(np.arange(256)[None, :] >= 3, 0.0, -1e9).astype(np.float32).repeat(2, 0)
    step = r.integers(0, 64, size=(2, 1)).astype(np.int32)
    jl, jcache = JT.forward_cached(jcfg, pair.jparams, jnp.asarray(step), jcache, jnp.int32(100),
                                   pad_bias=jnp.asarray(pad))
    pl, pcache = PT.forward_cached(pcfg, pair.params, torch.from_numpy(step).long(), pcache, 100,
                                   pad_bias=torch.from_numpy(pad))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=TOL, rtol=0)


def test_engine_forward_matches_jax(pair):
    jeng, peng = pair.engines()
    ids = _prompts(2, 2, 40)
    mask = np.ones((2, 40), np.int32)
    mask[1, :5] = 0
    np.testing.assert_allclose(peng.forward(ids).numpy(), np.asarray(jeng.forward(ids)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(peng.forward(ids, attention_mask=mask).numpy(),
                               np.asarray(jeng.forward(ids, attention_mask=mask)),
                               atol=TOL, rtol=0)


def test_workspace_grows_and_smaller_batches_slice_it(pair):
    jeng, peng = pair.engines()
    for B, n in ((2, 30), (1, 10), (3, 50)):
        ids = _prompts(B + n, B, n)
        got, want = peng.generate(ids, max_new_tokens=6), jeng.generate(ids, max_new_tokens=6)
        pair.check_tokens(n, got, want)
        ws = peng._workspace
        if B == 1:
            assert ws[0] == 2, "a smaller batch must not replace the workspace"
        else:
            assert ws[0] == B and ws[1] == 256 and tuple(ws[2]["k"].shape)[1:3] == (B, 256)


def test_eos_stops_early(pair):
    jeng, peng = pair.engines()
    ids = _prompts(3, 1, 16)
    free = peng.generate(ids, max_new_tokens=10)[0, 16:]
    eos = int(free[2])
    i = int(np.nonzero(free == eos)[0][0])            # where it first appears
    got = peng.generate(ids, max_new_tokens=10, eos_token_id=eos)
    want = jeng.generate(ids, max_new_tokens=10, eos_token_id=eos)
    assert got.shape == (1, 16 + i + 1) and got[0, -1] == eos
    pair.check_tokens(16, got, np.asarray(want))
    two = np.concatenate([ids, _prompts(4, 1, 16)])
    got2 = peng.generate(two, max_new_tokens=10, eos_token_id=eos)
    want2 = np.asarray(jeng.generate(two, max_new_tokens=10, eos_token_id=eos))
    pair.check_tokens(16, got2, want2)
    first = np.nonzero(got2[0, 16:] == eos)[0]
    assert first.size and (got2[0, 16 + first[0]:] == eos).all()   # a done row keeps emitting eos


def test_generate_batch_paged_off_is_per_request_generate(pair):
    jeng, peng = pair.engines(serving={"paged": "off"})
    prompts = [p[0] for p in (_prompts(5, 1, 9), _prompts(6, 1, 140), _prompts(7, 1, 33))]
    got = peng.generate_batch(prompts, max_new_tokens=5)
    want = jeng.generate_batch(prompts, max_new_tokens=5)
    alone = [peng.generate(p[None, :], max_new_tokens=5, seed=i)[0] for i, p in enumerate(prompts)]
    for p, g, w, a in zip(prompts, got, want, alone):
        assert np.array_equal(g, a)
        pair.check_tokens(p.size, g[None, :], np.asarray(w)[None, :])


class _NoCacheLM:
    """A causal LM without a KV-cache forward: generate recomputes the full
    prefix per token, and generate_batch takes the static path."""

    def __init__(self, model):
        self.config, self._model = model.config, model

    def forward(self, params, tokens, attn_mask=None):
        return self._model.forward(params, tokens, attn_mask)


def test_full_prefix_fallback_matches_jax(pair):
    jeng, _ = pair.engines()
    peng = deepspeed_tpu_torch.init_inference(_NoCacheLM(pair.pmodel), params=pair.params,
                                              dtype="fp32", device="cpu")
    ids = _prompts(10, 2, 15)
    got = peng.generate(ids, max_new_tokens=6)
    assert peng._workspace is None                    # no KV workspace on this path
    pair.check_tokens(15, got, jeng.generate(ids, max_new_tokens=6))
    one = peng.generate_batch([ids[0]], max_new_tokens=6)[0]
    assert np.array_equal(one, got[0])


def test_max_seq_and_encoder_checks():
    model = CausalLM(TransformerConfig(**SHAPES["gpt2"]))
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu")
    with pytest.raises(ValueError, match="exceeds model max_seq 256"):
        eng.generate(_prompts(0, 1, 200), max_new_tokens=57)
    assert eng.generate(_prompts(0, 1, 200), max_new_tokens=56).shape == (1, 256)
    assert eng.generate(_prompts(0, 1, 7), max_new_tokens=0).shape == (1, 7)
    enc = CausalLM(TransformerConfig(**{**SHAPES["gpt2"], "causal": False}))
    eng = deepspeed_tpu_torch.init_inference(enc, dtype="fp32", device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        eng.generate(_prompts(0, 1, 7), max_new_tokens=2)


def test_sampling_is_seeded():
    """Temperature / top-k sampling draws from a torch.Generator seeded with
    ``seed`` on the engine's device: one seed repeats, another moves."""
    model = CausalLM(TransformerConfig(**SHAPES["llama"]))
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu")
    ids = _prompts(8, 2, 12)
    kw = dict(max_new_tokens=10, temperature=1.5, top_k=20)
    a, b = eng.generate(ids, seed=1, **kw), eng.generate(ids, seed=1, **kw)
    c = eng.generate(ids, seed=2, **kw)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert ((a >= 0) & (a < 64)).all()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_streaming_branch_matches_jax(monkeypatch, shape):
    """With the thresholds patched to 64, a prefill at offset 8 with a pad
    mask and a kernel-less decode step (``attention_backend="xla"``) stream
    over 64-key chunks in both packages; both agree with each other and with
    the unpatched grouped einsum."""
    import deepspeed_tpu.comm as dist
    kw = {**SHAPES[shape], "attention_backend": "xla", "remat": False}
    jcfg, pcfg = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jparams = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(0)))
    params = params_from_jax(pcfg, jparams)
    r = np.random.default_rng(7)
    prompt = r.integers(0, 64, size=(2, 24)).astype(np.int32)
    pad = np.where(np.arange(192)[None, :] >= 8, 0.0, -1e9).astype(np.float32).repeat(2, 0)

    def run_port():
        cache = PT.init_kv_cache(pcfg, 2, 192, dtype=torch.float32)
        t = torch.from_numpy(prompt).long()
        lp, cache = PT.forward_cached(pcfg, params, t, cache, 8, torch.from_numpy(pad))
        ld, _ = PT.forward_cached(pcfg, params, t[:, :1], cache, 32, torch.from_numpy(pad))
        return lp.numpy(), ld.numpy()

    def run_jax():
        cache = JT.init_kv_cache(jcfg, 2, 192, dtype=jnp.float32)
        lp, cache = JT.forward_cached(jcfg, jparams, jnp.asarray(prompt), cache, 8,
                                      pad_bias=jnp.asarray(pad))
        ld, _ = JT.forward_cached(jcfg, jparams, jnp.asarray(prompt[:, :1]), cache, 32,
                                  pad_bias=jnp.asarray(pad))
        return np.asarray(lp), np.asarray(ld)

    dist.set_mesh(None)
    dense = run_port()
    for mod in (JT, PT):
        monkeypatch.setattr(mod, "DENSE_STREAM_THRESHOLD", 64)
        monkeypatch.setattr(mod, "DENSE_STREAM_CHUNK", 64)
    calls = []
    real = PT.chunked_attention
    monkeypatch.setattr(PT, "chunked_attention", lambda *a: calls.append(1) or real(*a))
    streamed, want = run_port(), run_jax()
    assert len(calls) == 2 * pcfg.n_layer          # prefill and decode, every layer
    for got, ref, wnt in zip(streamed, dense, want):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, wnt, rtol=2e-4, atol=2e-4)


def test_decode_kernel_runs_once_per_layer_and_token():
    """The decode loop calls the dense decode attention once per layer for
    every token after the first (the prefill and the first token take none)."""
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    model = CausalLM(TransformerConfig(**SHAPES["llama"]))
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu")
    calls = []
    real = PT.decode_attention
    PT.decode_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = eng.generate(_prompts(9, 2, 10), max_new_tokens=7)
    finally:
        PT.decode_attention = real
    assert out.shape == (2, 17) and len(calls) == model.config.n_layer * 6
    assert dda.launches == 0                          # the CPU never counts a kernel launch
