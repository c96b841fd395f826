"""The port's paged model forwards against the JAX package's, with the same
weights carried across by ``params_from_jax``: a Llama-shaped model (rope,
rmsnorm, swiglu, GQA, Hd 64) and a GPT-2-shaped one (learned positions,
layernorm, gelu, tied embeddings, biases, MHA Hd 64). Logits and the updated
KV pools of prefill, prefill-chunk and decode agree at 1e-4 in fp32; so do
the copy-on-write block copy and the parameter layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import transformer as PT

TOL = 1e-4
SHAPES = {
    "llama": dict(vocab_size=128, max_seq=256, n_layer=2, n_head=4, n_kv_head=2,
                  d_model=256, d_ff=512, pos_embedding="rope", norm="rmsnorm",
                  activation="swiglu", tie_embeddings=False, norm_eps=1e-6, remat=False),
    "gpt2": dict(vocab_size=128, max_seq=256, n_layer=2, n_head=2, d_model=128,
                 pos_embedding="learned", norm="layernorm", activation="gelu",
                 tie_embeddings=True, attn_bias=True, remat=False),
}


def _jax_params(cfg, seed):
    """JAX init, with the zero/one biases and norm scales perturbed so every
    leaf matters."""
    tree = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(seed)))
    r = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "'b" in name or "scale" in name or "bias" in name:
            return (a + r.normal(size=a.shape) * 0.05).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(params=sorted(SHAPES), scope="module")
def pair(request):
    kw = SHAPES[request.param]
    jcfg = JT.TransformerConfig(**kw)
    pcfg = PT.TransformerConfig(**kw)
    tree = _jax_params(jcfg, 3)
    return jcfg, pcfg, tree, params_from_jax(pcfg, tree)


def _pools(jcfg, pcfg, nb=5, bs=128):
    return (JT.init_paged_kv_cache(jcfg, nb, bs, dtype=jnp.float32),
            PT.init_paged_kv_cache(pcfg, nb, bs, dtype=torch.float32))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0,
                               err_msg=what)


def test_paged_forwards_match_jax(pair):
    jcfg, pcfg, jparams, params = pair
    r = np.random.default_rng(0)
    jpools, pools = _pools(jcfg, pcfg)
    bs = 128

    # prefill: one request of L real tokens in a 128-bucket, table [2, 1]
    L, T = 10, 128
    table = np.asarray([2, 1], np.int32)
    toks = np.zeros((1, T), np.int32)
    toks[0, :L] = r.integers(0, jcfg.vocab_size, size=L)
    t = np.arange(T)
    slots = np.where(t < L, table[t // bs] * bs + t % bs, t % bs)
    jl, jpools = JT.forward_paged_prefill(jcfg, jparams, jnp.asarray(toks), jpools,
                                          jnp.asarray(slots, jnp.int32), jnp.int32(L - 1))
    pl, pools = PT.forward_paged_prefill(pcfg, params, torch.from_numpy(toks).long(), pools,
                                         torch.from_numpy(slots).long(), L - 1)
    _close(pl, jl, "prefill logits")
    _close(pools["k"], jpools["k"], "prefill k pool")
    _close(pools["v"], jpools["v"], "prefill v pool")

    # prefill chunk: 20 more tokens of the same request at start 10
    start, n = L, 20
    ctoks = np.zeros((1, T), np.int32)
    ctoks[0, :n] = r.integers(0, jcfg.vocab_size, size=n)
    p_t = start + t
    cslots = np.where(t < n, table[np.minimum(p_t // bs, 1)] * bs + p_t % bs, p_t % bs)
    bt = table[None, :]
    jl, jpools = JT.forward_paged_prefill_chunk(
        jcfg, jparams, jnp.asarray(ctoks), jpools, jnp.asarray(bt),
        jnp.asarray(cslots, jnp.int32), jnp.int32(start), jnp.int32(n - 1))
    pl, pools = PT.forward_paged_prefill_chunk(
        pcfg, params, torch.from_numpy(ctoks).long(), pools, torch.from_numpy(bt),
        torch.from_numpy(cslots).long(), start, n - 1)
    _close(pl, jl, "chunk logits")
    _close(pools["k"], jpools["k"], "chunk k pool")

    # decode: two fused steps, row 0 the request, row 1 an inactive row
    pos0 = start + n
    dbt = np.zeros((2, 2), np.int32)
    dbt[0] = table
    for step in range(2):
        pos = np.asarray([pos0 + step, 0], np.int32)
        dtoks = r.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jpools = JT.forward_paged_decode(jcfg, jparams, jnp.asarray(dtoks), jpools,
                                             jnp.asarray(dbt), jnp.asarray(pos))
        pl, pools = PT.forward_paged_decode(pcfg, params, torch.from_numpy(dtoks).long(),
                                            pools, torch.from_numpy(dbt),
                                            torch.from_numpy(pos))
        _close(pl[0], jl[0], f"decode {step} logits")
        _close(pools["k"], jpools["k"], f"decode {step} k pool")
        _close(pools["v"], jpools["v"], f"decode {step} v pool")

    # copy-on-write split of block 2 into block 3
    jpools = JT.copy_paged_block(jpools, jnp.int32(2), jnp.int32(3))
    pools = PT.copy_paged_block(pools, 2, 3)
    _close(pools["k"], jpools["k"], "cow k pool")
    _close(pools["v"], jpools["v"], "cow v pool")
    assert torch.equal(pools["k"][:, 3], pools["k"][:, 2])


def test_xla_backend_matches_kernel_backend(pair):
    """attention_backend='xla' (plain einsum paths) and the default (the
    kernels' plain versions on CPU) agree on prefill and decode."""
    _, pcfg, _, params = pair
    import dataclasses
    xcfg = dataclasses.replace(pcfg, attention_backend="xla")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, pcfg.vocab_size,
                                                               size=(1, 128)))
    outs = []
    for cfg in (pcfg, xcfg):
        pools = PT.init_paged_kv_cache(cfg, 3, 128, dtype=torch.float32)
        slots = torch.arange(128) + 128
        lp, pools = PT.forward_paged_prefill(cfg, params, toks, pools, slots, 50)
        bt = torch.tensor([[1, 0]], dtype=torch.int32)
        ld, _ = PT.forward_paged_decode(cfg, params, toks[:, 51:52], pools, bt,
                                        torch.tensor([51], dtype=torch.int32))
        outs.append((lp, ld))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)


def test_init_params_layout_matches_jax(pair):
    """The port's own random init produces the JAX tree's keys and shapes
    (per layer), so weights move between the packages unchanged."""
    jcfg, pcfg, jparams, _ = pair
    mine = PT.init_params(pcfg, torch.Generator().manual_seed(0)).to_dict()

    def shapes(tree, stacked=False):
        if isinstance(tree, dict):
            return {k: shapes(v, stacked) for k, v in tree.items()}
        return tuple(np.shape(tree))[1 if stacked else 0:]
    want = {k: shapes(v) for k, v in jparams.items() if k != "layers"}
    got = {k: shapes(v) for k, v in mine.items() if k != "layers"}
    assert got == want
    layer_want = shapes(jparams["layers"], stacked=True)
    assert len(mine["layers"]) == jcfg.n_layer
    for layer in mine["layers"]:
        assert shapes(layer) == layer_want
