"""The port's quantizer against the JAX package's
(``deepspeed_tpu/ops/quantizer/kernels.py``, ``runtime/quantize.py``):
round-to-nearest symmetric / asymmetric fake quantization bit-equal to JAX
on the same numpy inputs, ternary and binary with the same pattern and
scales within 1e-6 (their per-group means are sums in another order); the
stochastic rounding's plain version (exact support, an unbiased mean over
seeds, a seed that repeats and another that moves) and the Philox stream the
K8 kernel draws (Random123's known answers); the MoQ ``Quantizer``'s schedule, keys,
``state_dict`` and values equal to JAX's over N steps on the same tree,
with groups that span layers; one stacked JAX leaf quantized as its
per-layer port leaves, and the per-port-leaf alternative that misses; and
the training layer (``ops/transformer/training_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import kernels as JK
from deepspeed_tpu.ops.transformer import training_kernels as JTK
from deepspeed_tpu.runtime import quantize as JQ
from deepspeed_tpu_torch.ops.quantizer import kernels as K
from deepspeed_tpu_torch.ops.transformer import training_kernels as PTK
from deepspeed_tpu_torch.runtime import quantize as PQ
from deepspeed_tpu_torch.runtime.utils import jax_leaves, keystr

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LEAF_TOL = 3e-5


def _x(shape, seed, ties=False):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    if ties:       # exact .5 steps of the group scale: round half to even decides
        x.reshape(-1)[::7] = np.float32(0.5) * np.round(x.reshape(-1)[::7] * 8) / 4
    return x


@pytest.mark.parametrize("shape,groups,bits", [((64, 32), 4, 8), ((3, 40, 7), 3, 4),
                                               ((2, 6, 8), 3, 8), ((128,), 1, 16)])
@pytest.mark.parametrize("fn", ["ds_quantize", "ds_quantize_asym"])
def test_nearest_is_bit_equal_to_jax(shape, groups, bits, fn):
    x = _x(shape, groups * bits, ties=True)
    want = np.asarray(getattr(JK, fn)(jnp.asarray(x), groups, bits))
    got = getattr(K, fn)(torch.from_numpy(x), groups, bits).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fn", ["_quantize_ternary", "_quantize_binary"])
def test_ternary_and_binary_match_jax(fn):
    x = _x((6, 40), 5)
    want = np.asarray(getattr(JQ, fn)(jnp.asarray(x), 3))
    got = getattr(PQ, fn)(torch.from_numpy(x), 3).numpy()
    assert np.array_equal(np.sign(got), np.sign(want))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors: the stream the K8
    kernel draws, in plain PyTorch."""
    out = K.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in out) == want


def test_philox_noise_depends_on_the_stacked_index_only():
    whole = K.philox_uniform(5, 0, 1000)
    parts = torch.cat([K.philox_uniform(5, 0, 333), K.philox_uniform(5, 333, 667)])
    assert torch.equal(whole, parts)
    assert 0.0 <= float(whole.min()) and float(whole.max()) < 1.0
    assert abs(float(whole.mean()) - 0.5) < 4 * (1 / 12 / 1000) ** 0.5
    assert not torch.equal(whole, K.philox_uniform(6, 0, 1000))
    # the planted "one stream per block" fault repeats its noise
    faulty = K.philox_uniform(5, 0, 1024, counter_mod=128)
    assert torch.equal(faulty[:512], faulty[512:])


def _sr_grid_case(n=4096, bits=8):
    """x = (k + 0.3) * s with s a power of two (one element per group at
    max|x| = qmax * s), as bf16-exact fp32 values."""
    s = 2.0 ** -4
    qmax = 2 ** (bits - 1) - 1
    r = np.random.default_rng(1)
    k = r.integers(-20, 20, size=(4, n))
    x = ((k + 0.3) * s).astype(np.float32)
    x[:, 0] = qmax * s
    return torch.from_numpy(x), s


def test_sr_plain_support_and_unbiased_mean():
    x, s = _sr_grid_case()
    lo = torch.floor(x / s) * s
    outs = torch.stack([K.ds_sr_quantize(x, 4, 8, seed=i) for i in range(64)])
    assert bool(((outs == lo) | (outs == lo + s)).all())
    mean = outs.mean(0)
    frac = (x / s - torch.floor(x / s))
    sigma = s * torch.sqrt(frac * (1 - frac) / 64)
    # each element's mean over 64 seeds; overall within 4 sigma of x
    assert abs(float((mean - x).mean())) <= 4 * float(sigma.pow(2).mean().sqrt()) / \
        x.numel() ** 0.5 + 1e-9
    assert torch.equal(K.ds_sr_quantize(x, 4, 8, seed=3), K.ds_sr_quantize(x, 4, 8, seed=3))
    assert not torch.equal(K.ds_sr_quantize(x, 4, 8, seed=3), K.ds_sr_quantize(x, 4, 8, seed=4))


def test_sr_plain_with_given_noise_is_the_kernel_arithmetic():
    """With the kernel's own Philox noise handed in, the plain version is
    what the card computes; a group that spans two leaves takes its scale
    from both."""
    x = _x((2, 6, 8), 9)                          # 96 elements, 3 groups of 32
    flat = torch.from_numpy(x.reshape(3, -1))
    noise = K.philox_uniform(11, 0, 96).reshape(3, -1)
    want = K.sr_quantize_plain(flat, K._sym_scale(flat, 8)[0], 127.0, noise).reshape(2, 6, 8)
    leaves = [torch.from_numpy(x[0].copy()), torch.from_numpy(x[1].copy())]
    got = K.ds_sr_quantize_span(leaves, 3, 8, noise=noise)
    assert torch.equal(torch.stack(got), want)
    scale, qmax, gs = K._span_scales(leaves, 3, 8)
    assert gs == 32 and torch.equal(scale, K._sym_scale(flat, 8)[0].reshape(-1))
    K.ds_sr_quantize_span(leaves, 3, 8, noise=noise, out=leaves)      # in place
    assert torch.equal(torch.stack(leaves), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes,groups,bits", [
    ((7000,), 7, 8),                    # one leaf
    ((1001, 999, 1003), 7, 16),         # odd leaf sizes, groups of 429 spanning leaves
    ((1001, 999, 1003), 13, 14),        # groups of 231
    ((5, 11, 17), 3, 8),                # a group spans all three leaves
])
def test_span_scales_are_bit_equal_to_jax(sizes, groups, bits, dtype):
    """The port's group scales (the plain scale pass over leaves and the
    flat form) are the JAX package's ``_sym_scale`` bit for bit, and both
    are numpy's correctly rounded fp32 ``amax / qmax``."""
    r = np.random.default_rng(sum(sizes) + groups + bits)
    x = (r.normal(size=sum(sizes)) * 2.0 ** r.integers(-12, 12, size=sum(sizes))).astype(
        np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    flat = t.float().numpy().reshape(groups, -1)        # the leaf's values, as fp32
    want = np.asarray(JK._sym_scale(jnp.asarray(flat), bits)[0]).reshape(-1)
    qmax = np.float32(2 ** (bits - 1) - 1)
    assert np.array_equal(want, np.abs(flat).max(axis=1) / qmax)
    leaves = list(torch.split(t, list(sizes)))
    got, got_qmax, gs = K._span_scales(leaves, groups, bits)
    assert (got_qmax, gs) == (float(qmax), sum(sizes) // groups)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(K.span_scales(leaves, groups, bits)[0].numpy(), want)
    assert np.array_equal(K._sym_scale(torch.from_numpy(flat), bits)[0].numpy().reshape(-1), want)


def test_sr_asym_support():
    x = torch.from_numpy(_x((4, 64), 2))
    out = K.ds_sr_quantize_asym(x, 4, 4, seed=1)
    flat = x.reshape(4, -1)
    lo, hi = flat.amin(1, keepdim=True), flat.amax(1, keepdim=True)
    scale = (hi - lo) / 15
    q = (out.reshape(4, -1) - lo) / scale
    assert float((q - torch.round(q)).abs().max()) < 1e-4
    assert float(q.min()) >= -1e-4 and float(q.max()) <= 15 + 1e-4


def _tree(seed=0):
    """A two-layer tree whose stacked leaves split into 3 groups that span
    the layers (wq: 96 elements, groups of 32 over layers of 48)."""
    r = np.random.default_rng(seed)
    f = lambda *s: (r.normal(size=s) * 0.1).astype(np.float32)
    return {"embed": {"tokens": f(12, 8)},
            "layers": {"attn": {"wq": f(2, 6, 8), "bq": f(2, 6)},
                       "ln_attn": {"scale": 1.0 + f(2, 6)}},
            "ln_f": {"scale": 1.0 + f(8)}}


def _port_named(tree):
    named = {"embed.tokens": tree["embed"]["tokens"], "ln_f.scale": tree["ln_f"]["scale"]}
    for i in range(2):
        for path in (("attn", "wq"), ("attn", "bq"), ("ln_attn", "scale")):
            named[f"layers.{i}." + ".".join(path)] = tree["layers"][path[0]][path[1]][i]
    return {n: torch.from_numpy(np.array(a)) for n, a in named.items()}


def _stacked(named):
    out = {"embed": {"tokens": named["embed.tokens"].numpy()},
           "ln_f": {"scale": named["ln_f.scale"].numpy()}, "layers": {}}
    for path in (("attn", "wq"), ("attn", "bq"), ("ln_attn", "scale")):
        out["layers"].setdefault(path[0], {})[path[1]] = np.stack(
            [named[f"layers.{i}." + ".".join(path)].numpy() for i in range(2)])
    return out


def test_jax_leaves_follow_the_jax_flattened_order():
    tree = _tree()
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [keystr(p) for p in jax_leaves(_port_named(tree))] == want


@pytest.mark.parametrize("kw", [
    dict(q_groups=3, start_bits=10, target_bits=8, q_period=1),
    dict(q_groups=3, start_bits=12, target_bits=6, q_period=2, q_type="asymmetric"),
    dict(q_groups=3, start_bits=4, target_bits=1, q_period=1),
    dict(q_groups=3, start_bits=9, target_bits=8, q_period=1, q_mixed_fp16=True,
         q_change_ratio=0.2),
])
def test_quantizer_matches_jax_over_steps(kw):
    """Schedule, keys, state_dict and values after 7 steps on the same tree
    (nearest rounding, so both sides round alike)."""
    jq, pq = JQ.Quantizer(**kw), PQ.Quantizer(**kw)
    tree = _tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    named = _port_named(tree)
    for step in range(7):
        jtree = jq.quantize_tree(jtree)
        pq.quantize_tree(named)
        assert pq.state_dict() == jq.state_dict(), step
        got, want = _stacked(named), jax.tree.map(np.asarray, jtree)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.abs(g - w).max() <= LEAF_TOL * np.abs(w).max(), step
    assert set(pq.state_dict()["leaf_state"]) == {
        "['embed']['tokens']", "['layers']['attn']['bq']", "['layers']['attn']['wq']",
        "['layers']['ln_attn']['scale']"}
    assert pq.any_precision_switch() == jq.any_precision_switch()


def test_quantizer_overflow_and_resume():
    kw = dict(q_groups=3, start_bits=10, target_bits=8, q_period=1)
    pq = PQ.Quantizer(**kw)
    named = _port_named(_tree())
    before = {n: t.clone() for n, t in named.items()}
    pq.quantize_tree(named, overflow=True)          # a skipped fp16 step: nothing moves
    assert pq.qsteps == 0 and all(torch.equal(before[n], t) for n, t in named.items())
    for _ in range(3):
        pq.quantize_tree(named)
    resumed = PQ.Quantizer(**kw)
    resumed.load_state_dict(pq.state_dict())
    assert resumed.state_dict() == pq.state_dict()


def test_quantizer_refuses_eigenvalue():
    with pytest.raises(NotImplementedError, match="eigenvalue"):
        PQ.Quantizer(q_eigenvalue=True)


def test_per_port_leaf_quantize_misses_the_jax_leaf():
    """Quantizing each layer's leaf on its own (its own groups, the norm
    scales skipped as rank 1) is not what the JAX package computes on the
    stacked leaf; the span is."""
    tree = _tree(3)
    jq = JQ.Quantizer(q_groups=3, start_bits=8, target_bits=8)
    want = jax.tree.map(np.asarray, jq.quantize_tree(jax.tree.map(jnp.asarray, tree)))
    named = _port_named(tree)
    naive = {n: (K.ds_quantize(t, 2, 8) if t.dim() >= 2 else t) for n, t in named.items()}
    err = lambda got: max(float(np.abs(g - w).max() / np.abs(w).max())
                          for g, w in zip(jax.tree.leaves(_stacked(got)), jax.tree.leaves(want)))
    assert err(naive) > 100 * LEAF_TOL
    PQ.Quantizer(q_groups=3, start_bits=8, target_bits=8).quantize_tree(named)
    assert err(named) <= LEAF_TOL


def _layer_params(port_layer, seed):
    """One layer's params in both layouts from the port's init."""
    p = port_layer.init_params(torch.Generator().manual_seed(seed))
    return p, jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)


def test_training_layer_matches_jax():
    cfg = dict(batch_size=2, hidden_size=64, heads=2, seq_length=16, layer_norm_eps=1e-5)
    player = PTK.DeepSpeedTransformerLayer(PTK.DeepSpeedTransformerConfig(**cfg))
    jlayer = JTK.DeepSpeedTransformerLayer(JTK.DeepSpeedTransformerConfig(**cfg))
    pp, jp = _layer_params(player, 0)
    x = np.random.default_rng(0).normal(size=(2, 16, 64)).astype(np.float32)
    want = np.asarray(jlayer(jp, jnp.asarray(x)))
    got = player(pp, torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_training_layer_stochastic_mode():
    """stochastic_mode rounds the input to 16-bit groups (one per row) with
    the layer's seed stream: a given seed repeats, the next call moves, and
    the result stays within the 16-bit grid's error of the plain layer."""
    cfg = dict(batch_size=2, hidden_size=64, heads=2, seq_length=16, layer_norm_eps=1e-5)
    sr = PTK.DeepSpeedTransformerLayer(PTK.DeepSpeedTransformerConfig(stochastic_mode=True,
                                                                      **cfg))
    plain = PTK.DeepSpeedTransformerLayer(PTK.DeepSpeedTransformerConfig(**cfg))
    params, _ = _layer_params(plain, 1)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 64)).astype(np.float32))
    a, b = sr(params, x, seed=5), sr(params, x, seed=5)
    assert torch.equal(a, b)
    first, second = sr(params, x), sr(params, x)
    assert not torch.equal(first, second)
    ref = plain(params, x)
    assert float((a - ref).abs().max()) <= 1e-2 * float(ref.abs().max())
