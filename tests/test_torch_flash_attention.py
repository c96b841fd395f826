"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's ``flash_attention`` runs its plain version; the JAX
side runs its TPU kernels in interpret mode: the packed-heads kernel (K2)
for MHA at Hd = 64 with no mask, ALiBi or padding, the general kernel (K1)
otherwise. Same seeded numpy inputs, fp32, 1e-5 (the JAX package's own
kernel pin). The CUDA kernel itself is held to the plain version on the
card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TOL = 1e-5

# (B, S, H, KV, Hd, causal, alibi, mask)
CASES = {
    "mha_hd64_packed": (2, 64, 4, 4, 64, True, False, False),
    "mha_hd64_full_packed": (1, 64, 2, 2, 64, False, False, False),
    "gqa2_hd128": (1, 64, 4, 2, 128, True, False, False),
    "gqa4_hd128": (2, 32, 8, 2, 128, True, False, False),
    "full_alibi_mask": (2, 40, 4, 2, 64, False, True, True),
    "causal_alibi": (1, 48, 4, 4, 64, True, True, False),
    "causal_mask_unaligned": (2, 37, 4, 1, 64, True, False, True),
    "unaligned_gqa_hd128": (1, 70, 4, 2, 128, True, False, False),
}


def _inputs(seed, B, S, H, KV, Hd, alibi, mask):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, S, H, Hd)).astype(np.float32)
    k = r.normal(size=(B, S, KV, Hd)).astype(np.float32)
    v = r.normal(size=(B, S, KV, Hd)).astype(np.float32)
    slopes = r.uniform(0.05, 0.4, size=H).astype(np.float32) if alibi else None
    bias = None
    if mask:
        keep = r.random((B, S)) > 0.25
        keep[:, 0] = True
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, slopes, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name):
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, Hd, causal, alibi, mask = CASES[name]
    q, k, v, slopes, bias = _inputs(sorted(CASES).index(name), B, S, H, KV, Hd, alibi, mask)
    want = np.asarray(jax_flash(_j(q), _j(k), _j(v), mask_bias=_j(bias), causal=causal,
                                alibi_slopes=_j(slopes), interpret=True))
    got = fa.flash_attention(_t(q), _t(k), _t(v), mask_bias=_t(bias), causal=causal,
                             alibi_slopes=_t(slopes))
    assert got.shape == (B, S, H, Hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_lse_matches_jax_kernel():
    """The log2-domain lse [B, H, S] the backward slice will read."""
    q, k, v, slopes, _ = _inputs(7, 2, 40, 4, 2, 64, True, False)
    want_o, want_lse = jax_flash(_j(q), _j(k), _j(v), alibi_slopes=_j(slopes),
                                 return_lse=True, interpret=True)
    got_o, got_lse = fa.flash_attention(_t(q), _t(k), _t(v), alibi_slopes=_t(slopes),
                                        return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=TOL, rtol=1e-6)


def test_bucket_with_junk_tail_rows():
    """Prefill runs a 128-token bucket whose tail rows are junk pads: the
    real rows equal attention over the real tokens alone, in both packages."""
    L, T = 45, 128
    q, k, v, _, _ = _inputs(11, 1, T, 4, 2, 64, False, False)
    want = np.asarray(jax_flash(_j(q), _j(k), _j(v), interpret=True))
    got = fa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    alone = fa.flash_attention(_t(q[:, :L]), _t(k[:, :L]), _t(v[:, :L])).numpy()
    np.testing.assert_allclose(got[:, :L], alone, atol=TOL, rtol=0)


def test_block_layout_refused():
    """Layouts the kernels cannot tile are refused as the JAX package
    refuses them; a dense layout is plain attention (layouts themselves are
    held to the JAX kernel by tests/test_torch_sparse_attention.py)."""
    q = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 16, 2, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="not divisible by layout blocks"):
        fa.flash_attention(q, q, q, block_layout=np.ones((2, 3, 3)))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q, q, q, block_layout=np.ones((2, 4, 4)))
    for jax_layout in (np.ones((2, 4, 4)), np.ones((2, 3, 3))):
        with pytest.raises(ValueError, match="layout"):
            jax_flash(_j(q.numpy()), _j(q.numpy()), _j(q.numpy()),
                      block_layout=jnp.asarray(jax_layout), interpret=True)
    dense = fa.flash_attention(q, q, q, block_layout=np.ones((2, 2, 2)))
    torch.testing.assert_close(dense, fa.flash_attention(q, q, q), atol=0, rtol=0)


def test_head_dim_padding_matches_plain_at_hd96():
    """What the kernel wrappers do at a head_dim between the kernels' 64 and
    128: zero columns up to 128, the scale of the true Hd, the outputs
    sliced back. Against the plain versions at Hd 96: o, lse, dq, dk, dv."""
    q, k, v, slopes, bias = _inputs(12, 2, 40, 4, 2, 96, True, True)
    do = np.random.default_rng(13).normal(size=q.shape).astype(np.float32)
    q, k, v, do, slopes, bias = map(_t, (q, k, v, do, slopes, bias))
    kw = {"mask_bias": bias, "alibi_slopes": slopes, "causal": True}
    hd = fa.kernel_head_dim(96)
    assert hd == 128 and fa.kernel_head_dim(64) == 64 and fa.kernel_head_dim(40) == 64
    pq, pk, pv, pdo = (fa.pad_head_dim(x, hd) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(q, k, v, **kw)
    po, plse = fa.flash_attention_plain(pq, pk, pv, scale=96**-0.5, **kw)
    torch.testing.assert_close(po[..., :96], o, atol=TOL, rtol=0)
    assert float(po[..., 96:].abs().max()) == 0.0
    torch.testing.assert_close(plse, lse, atol=TOL, rtol=0)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args, pargs = (q, k, v, do, lse, delta), (pq, pk, pv, pdo, plse, delta)
    dq = fa.flash_attention_dq_plain(*args, **kw)
    pdq = fa.flash_attention_dq_plain(*pargs, scale=96**-0.5, **kw)
    torch.testing.assert_close(pdq[..., :96], dq, atol=TOL, rtol=0)
    for got, want in zip(fa.flash_attention_dkv_plain(*pargs, scale=96**-0.5, **kw),
                         fa.flash_attention_dkv_plain(*args, **kw)):
        torch.testing.assert_close(got[..., :96], want, atol=TOL, rtol=0)
    for bad in (100, 136):
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            fa.kernel_head_dim(bad)
