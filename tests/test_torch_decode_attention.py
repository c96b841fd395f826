"""The port's dense decode attention against the JAX package's Pallas kernel
(K5, interpret mode), mirroring ``tests/unit/ops/test_decode_attention.py``:
MHA, GQA and MQA, Hd 64 and 128, Smax 128-512, pos at the first token, mid
and the last slot, pad bias and ALiBi on and off, and random configurations.
fp32, 2e-5 absolute (fp32 sums in another order). The kernel's split
algorithm (``splits=``: 1, 2 and one per 128-key block, at pos 0, on a split
boundary and with the later splits empty) against the same kernel at 1e-5.
A bf16 cache keeps bf16 out, within one bf16 ulp of the JAX kernel.
Off-envelope shapes return None in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
from deepspeed_tpu_torch.ops.transformer import inference_kernels as ik

TOL = 2e-5


def _case(r, B, H, KV, Hd, Smax, bias, alibi):
    q = r.normal(size=(B, H, Hd)).astype(np.float32)
    ck = r.normal(size=(B, Smax, KV, Hd)).astype(np.float32)
    cv = r.normal(size=(B, Smax, KV, Hd)).astype(np.float32)
    pad = (r.normal(size=(B, Smax)) * 0.2).astype(np.float32) if bias else None
    slopes = r.uniform(0.01, 0.5, size=H).astype(np.float32) if alibi else None
    return q, ck, cv, pad, slopes


def _both(q, ck, cv, pos, pad=None, slopes=None, dtype=np.float32):
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))
    jd = {np.float32: jnp.float32}.get(dtype, jnp.bfloat16)
    td = {np.float32: torch.float32}.get(dtype, torch.bfloat16)
    want = jax_decode(j(q).astype(jd), j(ck).astype(jd), j(cv).astype(jd), pos,
                      pad_bias=j(pad), alibi_slopes=j(slopes), interpret=True)
    got = dda.decode_attention(t(q).to(td), t(ck).to(td), t(cv).to(td), pos, pad_bias=t(pad),
                               alibi_slopes=t(slopes))
    return got, want


CASES = [
    (2, 8, 8, 64, 256, 17),    # MHA
    (2, 8, 2, 64, 256, 200),   # GQA 4:1
    (1, 12, 4, 128, 512, 0),   # first token
    (3, 4, 1, 64, 384, 383),   # MQA, last slot
]


@pytest.mark.parametrize("B,H,KV,Hd,Smax,pos", CASES)
@pytest.mark.parametrize("bias,alibi", [(False, False), (True, True)])
def test_plain_matches_jax_kernel(B, H, KV, Hd, Smax, pos, bias, alibi):
    r = np.random.default_rng(B * 100 + H * 10 + KV)
    q, ck, cv, pad, slopes = _case(r, B, H, KV, Hd, Smax, bias, alibi)
    got, want = _both(q, ck, cv, pos, pad, slopes)
    assert got.shape == (B, H, Hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_random_configurations(seed):
    r = np.random.default_rng(100 + seed)
    B, KV = int(r.integers(1, 4)), int(r.choice([1, 2, 4]))
    H, Hd = KV * int(r.choice([1, 2, 4])), int(r.choice([64, 128]))
    Smax = 128 * int(r.integers(1, 5))
    pos = int(r.integers(0, Smax))
    q, ck, cv, pad, slopes = _case(r, B, H, KV, Hd, Smax, r.integers(0, 2), r.integers(0, 2))
    got, want = _both(q, ck, cv, pos, pad, slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


# (B, H, KV, Hd, Smax, pos, bias, alibi): pos 0; pos on a split boundary
# (the first key of split 1); the last key of a split at G 4; later splits
# all empty (pos 300 of 1024 slots)
SPLIT_CASES = [
    (2, 4, 4, 64, 512, 0, False, False),
    (2, 4, 4, 64, 512, 128, True, True),
    (2, 8, 2, 64, 512, 255, False, True),
    (1, 8, 2, 128, 1024, 300, True, False),
]


@pytest.mark.parametrize("B,H,KV,Hd,Smax,pos,bias,alibi", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, "per_block"])
def test_split_plain_matches_jax_kernel(B, H, KV, Hd, Smax, pos, bias, alibi, splits):
    """The kernel's split algorithm in plain PyTorch (per-split fp32
    partials merged in split order; one split per 128-key block is the
    kernel's) against the JAX kernel, fp32, 1e-5."""
    splits = Smax // 128 if splits == "per_block" else splits
    r = np.random.default_rng(Smax + pos + H)
    q, ck, cv, pad, slopes = _case(r, B, H, KV, Hd, Smax, bias, alibi)
    _, want = _both(q, ck, cv, pos, pad, slopes)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = dda.decode_attention_plain(t(q), t(ck), t(cv), pos, t(pad), t(slopes), splits=splits)
    assert got.shape == (B, H, Hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    m, l, acc, live = dda.decode_partials_plain(t(q), t(ck), t(cv), pos, splits=splits)
    width = -(-Smax // splits)
    assert live[0].tolist() == [i * width <= pos for i in range(splits)]


def test_bf16_cache():
    r = np.random.default_rng(0)
    q, ck, cv, _, _ = _case(r, 2, 8, 4, 64, 256, False, False)
    got, want = _both(q, ck, cv, 100, dtype="bf16")
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.abs(want).max(-1, keepdims=True))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_envelope_returns_none_in_both():
    for Hd, Smax in ((48, 128), (64, 100)):      # odd head dim; Smax not 128-aligned
        q = np.zeros((1, 6, Hd), np.float32)
        ck = np.zeros((1, Smax, 6, Hd), np.float32)
        assert dda.dense_envelope_ok(6, 6, Hd, Smax) is False
        got, want = _both(q, ck, ck, 0)
        assert got is None and want is None
    with pytest.raises(ValueError, match="envelope"):
        ik.softmax_context(torch.zeros(1, 6, 48), torch.zeros(1, 128, 6, 48),
                           torch.zeros(1, 128, 6, 48), 0)


def test_softmax_context_is_the_kernel():
    r = np.random.default_rng(3)
    q, ck, cv, pad, slopes = _case(r, 2, 4, 2, 64, 128, True, True)
    t = torch.from_numpy
    a = ik.softmax_context(t(q), t(ck), t(cv), 50, pad_bias=t(pad), alibi_slopes=t(slopes))
    b = dda.decode_attention(t(q), t(ck), t(cv), 50, pad_bias=t(pad), alibi_slopes=t(slopes))
    assert torch.equal(a, b)
