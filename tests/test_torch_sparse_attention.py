"""The port's block-sparse attention (``ops/sparse_attention/`` and
``flash_attention(block_layout=...)``) against the JAX package's.

Same seeded numpy inputs to both, fp32, on the CPU: the JAX side runs its
Pallas flash kernel in interpret mode (``interpret=True``) or its dense
``SparseSelfAttention`` (``backend="dense"``), as
``tests/unit/ops/test_sparse_attention.py`` runs them; the port runs the
kernels' plain layout-aware versions (the wrappers take them for CPU tensors
only). Layouts bit-equal; the forward within 2e-5; dq, dk and dv within 1e-4
(one tiny case through the JAX kernel's interpret-mode backward, the rest
against ``jax.grad`` of the dense form, which computes the same function on
rows that keep a key). The kernels themselves are held to the plain versions
on the card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops import sparse_attention as psa
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# name -> (config class, keyword arguments), each made in both packages
CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=16)),
    "fixed_uni": ("FixedSparsityConfig", dict(num_heads=3, block=16, num_local_blocks=4,
                                              attention="unidirectional")),
    "fixed_patterns": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=2, num_different_global_patterns=2,
        horizontal_global_attention=True)),
    "variable": ("VariableSparsityConfig", dict(
        num_heads=3, block=16, num_random_blocks=2, local_window_blocks=[1, 2, 3],
        global_block_indices=[0, 5], global_block_end_indices=[2, 7],
        horizontal_global_attention=True)),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=3, block=16,
                                              different_layout_per_head=True,
                                              num_random_blocks=2)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                                        global_block_indices=[1, 6],
                                                        attention="unidirectional")),
    "sliding": ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16,
                                                         num_sliding_window_blocks=5)),
}


@pytest.mark.parametrize("S", [64, 256, 400])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_bit_equal_to_jax(name, S):
    cls, kw = CONFIGS[name]
    want = getattr(jsa, cls)(**kw).make_layout(S)
    got = getattr(psa, cls)(**kw).make_layout(S)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_layout_config_errors_match_jax():
    for pkg in (jsa, psa):
        with pytest.raises(ValueError, match="divisible by block"):
            pkg.FixedSparsityConfig(num_heads=2, block=16).make_layout(40)
        with pytest.raises(ValueError, match="num_local_blocks"):
            pkg.FixedSparsityConfig(num_heads=2, num_local_blocks=3, num_global_blocks=2)
        with pytest.raises(ValueError, match="need >= 3 blocks"):
            pkg.BigBirdSparsityConfig(num_heads=2, block=16).make_layout(32)


def _qkv(seed, B, S, H, KV, Hd):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, Hd)).astype(np.float32),
            r.normal(size=(B, S, KV, Hd)).astype(np.float32),
            r.normal(size=(B, S, KV, Hd)).astype(np.float32))


def _random_layout(seed, H, nb, dead_row=None):
    lay = (np.random.default_rng(seed).random((H, nb, nb)) > 0.5).astype(np.int64)
    if dead_row is not None:
        lay[0, dead_row] = 0
    return lay


# (B, S, H, KV, Hd, layout, causal, mask); the layout is "random<block>" (a
# random [H, nb, nb] layout, "+dead": head 0's row block 1 all zero), "2d<block>"
# (one random [nb, nb] layout for every head) or a sparsity config's
FWD_CASES = {
    "block128_fixed": (1, 256, 2, 2, 32, "fixed128", True, False),
    "block64_random_gqa": (2, 256, 4, 2, 32, "random64", False, False),
    "block32_random_mask": (1, 128, 2, 2, 64, "random32", True, True),
    "block32_2d_layout": (1, 128, 4, 4, 32, "2d32", False, False),
    "block16_gqa4_dead_row": (2, 64, 4, 1, 32, "random16+dead", True, False),
    "block32_bigbird_mask_dead_row": (1, 128, 2, 2, 32, "random32+dead", False, True),
}


def _case_layout(spec, H, S, seed):
    dead = 1 if spec.endswith("+dead") else None
    spec = spec.split("+")[0]
    if spec == "fixed128":
        return jsa.FixedSparsityConfig(num_heads=H, block=128, num_local_blocks=1,
                                       attention="unidirectional").make_layout(S)
    block = int(spec.lstrip("random2d"))
    lay = _random_layout(seed, H, S // block, dead)
    return lay[0] if spec.startswith("2d") else lay


def _mask(seed, B, S):
    keep = np.random.default_rng(seed + 1).random((B, S)) > 0.25
    keep[:, 0] = True
    return np.where(keep, 0.0, -1e9).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_layout_forward_matches_jax_kernel(name):
    B, S, H, KV, Hd, spec, causal, mask = FWD_CASES[name]
    seed = sorted(FWD_CASES).index(name)
    q, k, v = _qkv(seed, B, S, H, KV, Hd)
    lay = _case_layout(spec, H, S, seed)
    mb = _mask(seed, B, S) if mask else None
    want_o, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 mask_bias=None if mb is None else jnp.asarray(mb),
                                 causal=causal, block_layout=jnp.asarray(lay),
                                 interpret=True, return_lse=True)
    got_o, got_lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v),
                                        mask_bias=None if mb is None else torch.from_numpy(mb),
                                        causal=causal, block_layout=torch.from_numpy(lay),
                                        return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=FWD_TOL, rtol=1e-6)
    if spec.endswith("+dead"):            # head 0's row block 1 keeps no key
        block = S // lay.shape[-1]
        rows = slice(block, 2 * block)
        assert float(got_o[:, rows, 0].abs().max()) == 0.0
        assert bool((got_lse[:, 0, rows] == 1e30).all())


def _port_grads(q, k, v, lay, causal, mb, do):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask_bias=None if mb is None else torch.from_numpy(mb),
                             causal=causal, block_layout=torch.from_numpy(lay))
    out.backward(torch.from_numpy(do))
    return [x.grad.numpy() for x in leaves]


def test_layout_gradients_match_jax_kernel_backward():
    """dq, dk, dv through the JAX kernel's own interpret-mode backward
    (``_dq_kernel`` / ``_dkv_kernel`` with has_layout), GQA 2, a dead row."""
    B, S, H, KV, Hd, causal = 1, 64, 2, 1, 32, True
    q, k, v = _qkv(20, B, S, H, KV, Hd)
    lay = _random_layout(20, H, 4, dead_row=1)
    do = np.random.default_rng(21).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=causal, block_layout=jnp.asarray(lay), interpret=True)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_grads(q, k, v, lay, causal, None, do)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")


# (B, S, H, Hd, config, causal, mask): against jax.grad of the dense
# SparseSelfAttention (MHA, every row keeps a key)
GRAD_CASES = {
    "fixed_block32_causal": (2, 128, 2, 32, ("FixedSparsityConfig",
                                             dict(num_heads=2, block=32, num_local_blocks=2,
                                                  attention="unidirectional")), True, False),
    "bigbird_block32_mask": (1, 256, 4, 32, ("BigBirdSparsityConfig",
                                             dict(num_heads=4, block=32,
                                                  different_layout_per_head=True)), False, True),
    "bslongformer_block64": (1, 256, 2, 64, ("BSLongformerSparsityConfig",
                                             dict(num_heads=2, block=64,
                                                  num_sliding_window_blocks=1)), False, False),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_layout_gradients_match_jax_dense_sparse_attention(name):
    B, S, H, Hd, (cls, kw), causal, mask = GRAD_CASES[name]
    seed = 30 + sorted(GRAD_CASES).index(name)
    q, k, v = _qkv(seed, B, S, H, H, Hd)
    do = np.random.default_rng(seed).normal(size=q.shape).astype(np.float32)
    mb = _mask(seed, B, S) if mask else None
    jattn = jsa.SparseSelfAttention(getattr(jsa, cls)(**kw), backend="dense")
    lay = np.asarray(jattn.get_layout(S))

    def loss(q_, k_, v_):
        kpm = None if mb is None else jnp.asarray(mb)
        return jnp.sum(jattn(q_, k_, v_, key_padding_mask=kpm) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_grads(q, k, v, lay, causal, mb, do)
    for g, w, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_sparse_self_attention_matches_jax(backend):
    """The module, with an int key-padding mask and (dense only) an
    attention mask; "pallas" is the kernel path in both packages."""
    B, S, H, Hd = 2, 128, 2, 32
    q, k, v = _qkv(40, B, S, H, H, Hd)
    kpm = (np.random.default_rng(41).random((B, S)) > 0.2).astype(np.int32)
    kpm[:, 0] = 1
    am = None
    if backend == "dense":
        am = np.tril(np.ones((S, S), np.int32))[None, None]
    kw = dict(num_heads=H, block=32, num_local_blocks=2, attention="unidirectional")
    jattn = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**kw), backend=backend)
    pattn = psa.SparseSelfAttention(psa.FixedSparsityConfig(**kw), backend=backend)
    want = jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_padding_mask=jnp.asarray(kpm),
                 attn_mask=None if am is None else jnp.asarray(am))
    got = pattn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                key_padding_mask=torch.from_numpy(kpm),
                attn_mask=None if am is None else torch.from_numpy(am))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    assert pattn.get_layout(S) is pattn.get_layout(S)           # made once a length
    with pytest.raises(ValueError, match="backend"):
        psa.SparseSelfAttention(backend="triton")


def test_sparse_attention_core_dense_path_and_its_refusal():
    B, S, H, Hd = 1, 128, 2, 32
    q, k, v = _qkv(50, B, S, H, H, Hd)
    lay = _random_layout(50, H, 4)
    bias = np.random.default_rng(51).normal(size=(B, H, S, S)).astype(np.float32)
    mb = _mask(51, B, S)
    want = jsa.sparse_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lay, 32,
                                     True, jnp.asarray(mb), scale=0.2, use_pallas=True,
                                     attn_bias=jnp.asarray(bias))
    got = psa.sparse_attention_core(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(lay), 32, True,
                                    torch.from_numpy(mb), scale=0.2, use_pallas=True,
                                    attn_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    np.testing.assert_array_equal(psa.layout_to_token_bias(torch.from_numpy(lay), 32, S).numpy(),
                                  np.asarray(jsa.layout_to_token_bias(lay, 32, S)))
    S = jsa.sparse_self_attention.DENSE_SPARSE_MAX_SEQ + 128
    assert psa.sparse_self_attention.DENSE_SPARSE_MAX_SEQ == S - 128
    big = np.zeros((1, S, 1, 8), np.float32)
    lay = np.ones((1, S // 128, S // 128), np.int64)
    with pytest.raises(NotImplementedError, match="DENSE|block-sparse kernel path"):
        jsa.sparse_attention_core(jnp.asarray(big), jnp.asarray(big), jnp.asarray(big), lay, 128,
                                  True, use_pallas=False)
    with pytest.raises(NotImplementedError, match="block-sparse kernel path"):
        psa.sparse_attention_core(torch.from_numpy(big), torch.from_numpy(big),
                                  torch.from_numpy(big), torch.from_numpy(lay), 128, True,
                                  use_pallas=False)


def test_pad_and_unpad_round_trip_match_jax():
    ids = np.random.default_rng(60).integers(1, 50, size=(2, 37)).astype(np.int32)
    tt = np.zeros_like(ids)
    want = jsa.pad_to_block_size(16, jnp.asarray(ids), None, jnp.asarray(tt), pad_token_id=3)
    got = psa.pad_to_block_size(16, torch.from_numpy(ids), None, torch.from_numpy(tt),
                                pad_token_id=3)
    assert got[0] == want[0] == 11
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = torch.arange(2 * 48 * 3).reshape(2, 48, 3)
    np.testing.assert_array_equal(psa.unpad_sequence_output(11, out).numpy(),
                                  np.asarray(jsa.unpad_sequence_output(11, jnp.asarray(out))))
    assert psa.pad_to_block_size(16, torch.from_numpy(ids[:, :32]))[0] == 0
    assert psa.unpad_sequence_output(0, out) is out


GPT2 = dict(vocab_size=64, max_seq=32, n_layer=1, n_head=2, d_model=32,
            pos_embedding="learned", norm="layernorm", activation="gelu", tie_embeddings=True,
            attn_bias=True)


def test_extend_position_embedding_on_a_gpt2_tree():
    jcfg = JT.TransformerConfig(**GPT2)
    jtree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(0)))
    model = CausalLM(TransformerConfig(**GPT2))
    tree = params_from_jax(model.config, jtree)
    want = jsa.extend_position_embedding(jtree, 80)
    got = psa.extend_position_embedding(tree, 80)
    assert type(got) is type(tree) and got is not tree
    np.testing.assert_array_equal(got["embed"]["positions"].detach().numpy(),
                                  np.asarray(want["embed"]["positions"]))
    assert tuple(tree["embed"]["positions"].shape) == (32, 32)       # the old tree unchanged
    np.testing.assert_array_equal(got["embed"]["tokens"].detach().numpy(),
                                  tree["embed"]["tokens"].detach().numpy())
    as_dict = psa.extend_position_embedding(tree.to_dict(), 40)
    assert isinstance(as_dict, dict) and as_dict["embed"]["positions"].shape == (40, 32)
    with pytest.raises(ValueError, match="does not exceed"):
        psa.extend_position_embedding(tree, 32)


def test_replace_self_attention_and_its_rejections():
    from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
    model = CausalLM(TransformerConfig(**GPT2))
    sc = psa.FixedSparsityConfig(num_heads=2, block=16)
    sparse = psa.replace_self_attention(model, sc, max_seq=64)
    assert type(sparse) is CausalLM and sparse is not model
    assert sparse.config.sparse_attention is sc and sparse.config.max_seq == 64
    assert model.config.sparse_attention is None and model.config.max_seq == 32
    assert psa.replace_self_attention(model, sc).config.max_seq == 32
    # the port's BertModel is sparsified through its backbone config, as
    # the JAX package does it
    bert = BertModel(BertConfig(vocab_size=32, n_layer=1, n_head=2, d_model=32, d_ff=64),
                     with_mlm_head=True)
    sparse_bert = psa.replace_self_attention(bert, sc, max_seq=1024)
    assert type(sparse_bert) is BertModel and sparse_bert.with_mlm_head
    assert sparse_bert.zoo_cfg.sparse_attention is sc and sparse_bert.config.max_seq == 1024
    assert sparse_bert.zoo_cfg.max_seq == 1024 and not sparse_bert.zoo_cfg.causal
    assert bert.zoo_cfg.sparse_attention is None and bert.config.max_seq == 512
    with pytest.raises(TypeError, match="cannot sparsify"):
        psa.replace_self_attention(torch.nn.Linear(2, 2), sc)


def test_the_ops_surface_matches_jax():
    from deepspeed_tpu.ops.sparse_attention import kernels as jk
    from deepspeed_tpu_torch.ops.sparse_attention import kernels as pk
    assert sorted(psa.__all__) == sorted(jsa.__all__)
    assert sorted(pk.__all__) == sorted(jk.__all__)


@pytest.mark.parametrize("S,nb,causal", [(600, 25, True), (512, 64, False), (1024, 8, True),
                                         (384, 3, False)])
def test_live_tile_lists_hold_exactly_the_live_pairs(S, nb, causal):
    """Each kernel's lists, against the token-level mask: a tile is listed
    when it holds a kept pair (below the diagonal when causal), flagged
    partial unless every pair of it inside S is kept, in the dense loops'
    order (A, C: k tiles ascending; D: group head, then q tile)."""
    H, KV = 4, 2
    lay = torch.from_numpy(_random_layout(S + nb, H, nb))
    keep = fa._layout_keep(lay, S, H, causal)
    lb = S // nb
    tok = keep.repeat_interleave(lb, 1).repeat_interleave(lb, 2)
    pairs = tok & torch.ones((S, S), dtype=torch.bool).tril() if causal else tok
    for kern, (tq, tk) in fa._TILES.items():
        nq, nk = -(-S // tq), -(-S // tk)
        want = []
        for h in range(H):
            for qt in range(nq):
                for kt in range(nk):
                    rows, cols = slice(qt * tq, (qt + 1) * tq), slice(kt * tk, (kt + 1) * tk)
                    if pairs[h, rows, cols].any():
                        want.append((h, qt, kt, int(not tok[h, rows, cols].all())))
        if kern == "dkv":             # lists by (kv head, key tile), entries (g, q tile)
            G = H // KV
            want.sort(key=lambda w: (w[0] // G, w[2], w[0] % G, w[1]))
            rows = [(h // G) * nk + kt for h, qt, kt, _ in want]
            codes = [((h % G) * nq + qt) * 2 + p for h, qt, kt, p in want]
            n_rows = KV * nk
        else:
            rows = [h * nq + qt for h, qt, kt, _ in want]
            codes = [kt * 2 + p for h, qt, kt, p in want]
            n_rows = H * nq
        offsets, entries = fa.live_tiles(keep, S, causal, kern, KV)
        assert entries.tolist() == codes, kern
        assert offsets.tolist() == [sum(r < i for r in rows) for i in range(n_rows + 1)], kern


def test_layout_pieces_are_cached_by_object_and_by_content():
    lay = psa.FixedSparsityConfig(num_heads=2, block=128, num_local_blocks=2,
                                  attention="unidirectional").make_layout(1024)
    a = fa._device_layout(lay, 1024, 2, True, "cpu")
    assert fa._device_layout(lay, 1024, 2, True, "cpu") is a
    assert fa._device_layout(lay.clone(), 1024, 2, True, "cpu") is a    # the same content
    lay[0, 5, 0] = 1 - lay[0, 5, 0]                                   # edited in place
    b = fa._device_layout(lay, 1024, 2, True, "cpu")
    assert b is not a and bool(b.keep[0, 5, 0]) != bool(a.keep[0, 5, 0])
    assert fa._device_layout(lay, 1024, 2, False, "cpu") is not b     # another mask
