"""Random-LTD in the port (``runtime/data_pipeline/data_routing``,
``ops/random_ltd``) against the JAX package's on the CPU.

The samplers draw from different generators (``jax.random`` against an
explicit ``torch.Generator``), so the parity cases feed the JAX package's
indices, as numpy, to the port's ``gather_tokens``, ``scatter_tokens``,
``slice_attention_mask`` and ``RandomLayerTokenDrop``: equal tensors, and a
wrapped transformer block (BERT-style post-LN with a padding mask, and a
causal Llama block) within 1e-5 of the JAX wrapper's output and its
gradient w.r.t. the input within 1e-5 of its largest value (fp32 sums in
other orders). The port's own samplers are held by their properties:
sorted, unique, in range, the count asked for, repeatable from a seed, and
a different draw from another seed; ``bert_sample_tokens``'s per-row sets
gather row by row, as the reference's ``gather_scatter.cu`` does.
``RandomLTDScheduler`` gives the JAX scheduler's count at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops.random_ltd import dropping_utils as jdu
from deepspeed_tpu.runtime.data_pipeline.data_routing import basic_layer as jbl
from deepspeed_tpu.runtime.data_pipeline.data_routing.scheduler import (
    RandomLTDScheduler as JaxLTDScheduler)
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.random_ltd import dropping_utils as pdu
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import basic_layer as pbl
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.scheduler import RandomLTDScheduler

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

OUT_TOL = 1e-5      # absolute on O(1) activations; gradients relative to their largest
BERT = dict(vocab_size=64, max_seq=32, n_layer=1, n_head=2, d_model=32, d_ff=64,
            pos_embedding="learned", norm="layernorm", activation="gelu_exact",
            norm_position="post", causal=False, attn_bias=True, attention_backend="xla")
LLAMA = dict(vocab_size=64, max_seq=32, n_layer=1, n_head=4, n_kv_head=2, d_model=32, d_ff=64,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             attention_backend="xla")


def _x(B=2, S=16, D=4, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("S,keep", [(16, 8), (24, 5), (16, 16)])
def test_token_ops_match_jax(S, keep):
    idx = np.array(jbl.token_sample(jax.random.key(S + keep), S, keep))
    x, full = _x(S=S), _x(S=S, seed=1)
    part = _x(S=keep, seed=2)
    mask = np.where(np.random.default_rng(3).random((2, S)) < 0.3, -1e9, 0.0).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(pbl.gather_tokens(t(x), idx).numpy(),
                                  np.asarray(jbl.gather_tokens(jnp.asarray(x), idx)))
    np.testing.assert_array_equal(pbl.scatter_tokens(t(full), t(part), idx).numpy(),
                                  np.asarray(jbl.scatter_tokens(jnp.asarray(full),
                                                                jnp.asarray(part), idx)))
    np.testing.assert_array_equal(pbl.slice_attention_mask(t(mask), idx).numpy(),
                                  np.asarray(jbl.slice_attention_mask(jnp.asarray(mask), idx)))
    assert pbl.slice_attention_mask(None, idx) is None


def _block_pair(kw):
    jcfg = JT.TransformerConfig(**kw)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(4)))
    pcfg = TransformerConfig(**kw)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    plp = params_from_jax(pcfg, tree)["layers"][0]
    return jcfg, jlp, pcfg, plp


@pytest.mark.parametrize("shape,keep", [("bert", 6), ("llama", 6), ("bert", 16)])
def test_layer_token_drop_over_a_block_matches_jax(shape, keep):
    """The JAX wrapper samples from its key; the port's is handed those
    indices. keep = S runs the plain layer in both."""
    kw = {"bert": BERT, "llama": LLAMA}[shape]
    jcfg, jlp, pcfg, plp = _block_pair(kw)
    B, S, D = 2, 16, kw["d_model"]
    x = _x(B, S, D, seed=5)
    lengths = [S, 11]
    attn = (np.arange(S)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    key = jax.random.key(9)

    def jlayer(h, mb):
        pos = jnp.broadcast_to(jnp.arange(h.shape[1])[None], h.shape[:2])
        return JT.block(jcfg, h, jlp, pos, mb)

    def plain_layer(h, mb):
        pos = torch.arange(h.shape[1])[None].expand(h.shape[:2])
        return PT.block(pcfg, h, plp, pos, mb)

    jmask = JT.key_mask_bias(jnp.asarray(attn))
    jwrap = jbl.RandomLayerTokenDrop(jlayer)
    want_out = np.asarray(jwrap(jnp.asarray(x), key, keep, jmask))
    jgrad = np.asarray(jax.grad(lambda h: jnp.sum(jnp.sin(jwrap(h, key, keep, jmask))))(
        jnp.asarray(x)))
    idx = None if keep >= S else np.array(jbl.token_sample(key, S, keep))
    xt = torch.from_numpy(x).requires_grad_()
    out = pbl.RandomLayerTokenDrop(plain_layer)(
        xt, None, keep, PT.key_mask_bias(torch.from_numpy(attn)), indices=idx)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=0,
                               atol=OUT_TOL * float(np.abs(jgrad).max()))
    if idx is not None:           # the dropped tokens rode the residual untouched
        dropped = np.setdiff1d(np.arange(S), idx)
        np.testing.assert_array_equal(out.detach().numpy()[:, dropped], x[:, dropped])


def _check_subsets(idx, S, keep):
    assert idx.shape[-1] == keep and idx.dtype == torch.int64
    flat = idx.reshape(-1, keep)
    assert bool((flat[:, 1:] > flat[:, :-1]).all())        # sorted and unique
    assert int(flat.min()) >= 0 and int(flat.max()) < S


def test_token_sample_properties():
    a = pbl.token_sample(torch.Generator().manual_seed(1), 40, 12)
    _check_subsets(a, 40, 12)
    assert torch.equal(a, pbl.token_sample(torch.Generator().manual_seed(1), 40, 12))
    assert not torch.equal(a, pbl.token_sample(torch.Generator().manual_seed(2), 40, 12))
    assert torch.equal(pbl.token_sample(None, 9, 9), torch.arange(9))
    # the wrapper's own draw: keep tokens changed, the rest untouched
    wrap = pbl.RandomLayerTokenDrop(lambda h, mb: h + 100.0)
    out = wrap(torch.zeros(1, 16, 2), torch.Generator().manual_seed(3), 4)
    assert int((out[0, :, 0] == 100.0).sum()) == 4
    assert bool((wrap(torch.zeros(1, 16, 2), None, 16) == 100.0).all())


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_sample_tokens_shapes_and_properties(kind):
    S, keep, B, L = 32, 10, 3, 4
    mask = torch.from_numpy(np.random.default_rng(0).standard_normal((B, S)).astype(np.float32))
    fn, jfn = {"gpt": (pdu.gpt_sample_tokens, jdu.gpt_sample_tokens),
               "bert": (pdu.bert_sample_tokens, jdu.bert_sample_tokens)}[kind]
    idx, sliced = fn(keep, S, B, layers=L, rng=torch.Generator().manual_seed(5), attn_mask=mask)
    jidx, jsliced = jfn(keep, S, B, layers=L, rng=jax.random.key(5),
                        attn_mask=jnp.asarray(mask.numpy()))
    assert idx.shape == tuple(jidx.shape) and sliced.shape == tuple(jsliced.shape)
    _check_subsets(idx, S, keep)
    for l in range(L):
        np.testing.assert_array_equal(sliced[l].numpy(),
                                      pbl.slice_attention_mask(mask, idx[l]).numpy())
    again, _ = fn(keep, S, B, layers=L, rng=torch.Generator().manual_seed(5))
    other, _ = fn(keep, S, B, layers=L, rng=torch.Generator().manual_seed(6))
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    assert fn(keep, S, B, layers=1)[1] is None
    assert torch.equal(fn(keep, S, B, layers=1)[0], fn(keep, S, B, layers=1)[0])


def test_per_row_indices_gather_row_by_row():
    """[B, keep] indices (bert_sample_tokens's) against a numpy row loop."""
    B, S, keep, D = 3, 12, 5, 4
    idx, _ = pdu.bert_sample_tokens(keep, S, B, layers=1, rng=torch.Generator().manual_seed(2))
    idx = idx[0]
    x, full, part = _x(B, S, D), _x(B, S, D, seed=1), _x(B, keep, D, seed=2)
    mask = np.random.default_rng(4).standard_normal((B, S)).astype(np.float32)
    rows = idx.numpy()
    want_g = np.stack([x[b, rows[b]] for b in range(B)])
    want_s = full.copy()
    for b in range(B):
        want_s[b, rows[b]] = part[b]
    t = torch.from_numpy
    np.testing.assert_array_equal(pbl.gather_tokens(t(x), idx).numpy(), want_g)
    np.testing.assert_array_equal(pbl.scatter_tokens(t(full), t(part), idx).numpy(), want_s)
    np.testing.assert_array_equal(pbl.slice_attention_mask(t(mask), idx).numpy(),
                                  np.stack([mask[b, rows[b]] for b in range(B)]))
    want_out = x.copy()
    for b in range(B):
        want_out[b, rows[b]] *= 2.0
    out = pbl.RandomLayerTokenDrop(lambda h, mb: h * 2.0)(t(x), None, keep, indices=idx)
    np.testing.assert_array_equal(out.numpy(), want_out)


@pytest.mark.parametrize("cfg", [
    {"random_ltd_schedule": {"min_value": 128, "max_value": 512, "schedule_type": "fixed_linear",
                             "schedule_config": {"require_steps": 20, "seq_per_step": 16}}},
    {"random_ltd_schedule": {"min_value": 64, "max_value": 500,
                             "schedule_config": {"total_curriculum_step": 37,
                                                 "seq_per_step": 24}}},
    {"schedule": {"min_value": 10, "max_value": 40}, "random_ltd_layer_num": 3,
     "random_ltd_layer_id": [1, 2, 3], "global_batch_size": 8},
])
def test_scheduler_matches_jax(cfg):
    got, want = RandomLTDScheduler(cfg), JaxLTDScheduler(cfg)
    assert got.get_current_seq() == want.get_current_seq()
    for step in range(0, 60):
        assert got.update_seq(step) == want.update_seq(step), step
        assert got.state_dict() == want.state_dict()
    fresh = RandomLTDScheduler(cfg)
    fresh.load_state_dict(got.state_dict())
    assert fresh.get_current_seq() == got.get_current_seq()
