"""The port's paged decode attention against the JAX package's Pallas
kernel (interpret mode) on random block tables, mirroring
``tests/unit/ops/test_paged_decode_attention.py``: B 1-3, KV in {1, 2, 4},
Hd in {64, 128}, block size 128, pad bias and ALiBi on and off, positions on
block boundaries, and the kernel's split algorithm (``splits=``: 1, 2 and
one per block, pos 0, on split boundaries, rows whose later splits are all
empty). fp32, 1e-5. Off-envelope shapes return None in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_decode_attention import \
    paged_decode_attention as jax_paged
from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

TOL = 1e-5


def random_paged_case(r, B, KV, Hd, bs, n_max, G=None):
    """Pools + per-request non-overlapping random block tables + positions."""
    H = KV * (int(r.choice([1, 2, 4])) if G is None else G)
    num_blocks = B * n_max + 1
    kp = r.normal(size=(num_blocks, bs, KV, Hd)).astype(np.float32)
    vp = r.normal(size=(num_blocks, bs, KV, Hd)).astype(np.float32)
    q = r.normal(size=(B, H, Hd)).astype(np.float32)
    perm = r.permutation(num_blocks - 1) + 1     # dummy block 0 never mapped
    bt = perm[:B * n_max].reshape(B, n_max).astype(np.int32)
    pos = r.integers(0, n_max * bs, size=B).astype(np.int32)
    return q, kp, vp, bt, pos


def _both(q, kp, vp, bt, pos, bias=None, slopes=None):
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))
    want = jax_paged(j(q), j(kp), j(vp), j(bt), j(pos), pad_bias=j(bias),
                     alibi_slopes=j(slopes), interpret=True)
    got = pda.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(pos), pad_bias=t(bias),
                                     alibi_slopes=t(slopes))
    return got, want


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_jax_kernel(seed):
    r = np.random.default_rng(200 + seed)
    B = int(r.integers(1, 4))
    KV = int(r.choice([1, 2, 4]))
    Hd = int(r.choice([64, 128]))
    n_max = int(r.integers(1, 4))
    q, kp, vp, bt, pos = random_paged_case(r, B, KV, Hd, 128, n_max)
    H = q.shape[1]
    bias = (r.normal(size=(B, n_max * 128)) * 0.2).astype(np.float32) if seed % 2 else None
    slopes = r.uniform(0.05, 0.4, size=H).astype(np.float32) if seed >= 2 else None
    got, want = _both(q, kp, vp, bt, pos, bias, slopes)
    assert got.shape == (B, H, Hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("Hd,G", [(64, 1), (128, 4)])
def test_positions_on_block_boundaries(Hd, G):
    """Rows at very different depths in one call, each masked by its own
    pos: the first token, the last slot of a block, the first of the next."""
    r = np.random.default_rng(11 + G)
    q, kp, vp, bt, _ = random_paged_case(r, 4, 2, Hd, 128, 3, G=G)
    pos = np.asarray([0, 127, 128, 255], np.int32)
    got, want = _both(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# (B, KV, G, Hd, n_max, pos, bias, alibi): pos 0, on a split boundary and at
# the last slot; rows at very different depths under one n_max (the later
# splits of most rows empty) at G 4 with pad bias and ALiBi; two rows past
# the first split with a pad bias
SPLIT_CASES = [
    (3, 2, 1, 64, 4, [0, 128, 511], False, False),
    (4, 2, 4, 128, 8, [1023, 0, 5, 127], True, True),
    (2, 1, 4, 64, 6, [256, 640], True, False),
]


@pytest.mark.parametrize("B,KV,G,Hd,n_max,pos,bias,alibi", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, "per_block"])
def test_split_plain_matches_jax_kernel(B, KV, G, Hd, n_max, pos, bias, alibi, splits):
    """The kernel's split algorithm in plain PyTorch (per-split fp32
    partials merged in split order, splits past pos[b] left out; one split
    per 128-key block is the kernel's) against the JAX kernel, fp32, 1e-5."""
    splits = n_max if splits == "per_block" else splits
    r = np.random.default_rng(31 * B + n_max + G)
    q, kp, vp, bt, _ = random_paged_case(r, B, KV, Hd, 128, n_max, G=G)
    pos = np.asarray(pos, np.int32)
    H = KV * G
    pad = (r.normal(size=(B, n_max * 128)) * 0.2).astype(np.float32) if bias else None
    slopes = r.uniform(0.05, 0.4, size=H).astype(np.float32) if alibi else None
    _, want = _both(q, kp, vp, bt, pos, pad, slopes)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = pda.paged_decode_attention_plain(t(q), t(kp), t(vp), t(bt), t(pos), t(pad),
                                           t(slopes), splits=splits)
    assert got.shape == (B, H, Hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    live = pda.paged_decode_partials_plain(t(q), t(kp), t(vp), t(bt), t(pos),
                                           splits=splits)[3]
    width = -(-n_max * 128 // splits)
    assert live.tolist() == [[i * width <= p for i in range(splits)] for p in pos]


def test_dead_tail_entries_are_ignored():
    """Table entries past a request's last live block may hold anything."""
    r = np.random.default_rng(5)
    q, kp, vp, bt, _ = random_paged_case(r, 2, 2, 64, 128, 3)
    pos = np.asarray([10, 140], np.int32)
    got, _ = _both(q, kp, vp, bt, pos)
    junk = bt.copy()
    junk[0, 1:] = 10**6
    junk[1, 2:] = -5
    got2 = pda.paged_decode_attention(*(torch.from_numpy(x) for x in (q, kp, vp, junk, pos)))
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


def test_envelope_returns_none_in_both():
    bt = np.zeros((1, 2), np.int32)
    pos = np.zeros(1, np.int32)
    for Hd, bs in ((64, 64), (48, 128)):           # block not 128-aligned; odd head dim
        q = np.zeros((1, 4, Hd), np.float32)
        kp = np.zeros((3, bs, 4, Hd), np.float32)
        assert pda.paged_envelope_ok(4, 4, Hd, bs) is False
        got, want = _both(q, kp, kp, bt, pos)
        assert got is None and want is None
