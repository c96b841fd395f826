"""The port's flash-attention backward against the JAX package's.

The port's plain dq / dk / dv (the math kernels C and D run on the card)
from its forward's o and lse, against ``jax.grad`` through the JAX
package's Pallas kernels in interpret mode: the packed-heads kernels (K2)
for MHA at Hd = 64 with no mask, ALiBi or padding, the general kernels (K1)
otherwise. Same seeded numpy inputs, fp32; gradients agree within 1e-5 of
each tensor's largest value (the fp32 sums run in other orders). The
autograd Function is held to ``torch.autograd`` through the plain forward.
The CUDA kernels themselves are held to the plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

TOL = 1e-5      # relative to the largest |value| of each gradient

# (B, S, H, KV, Hd, causal, alibi, mask)
CASES = {
    "mha_hd64_packed": (2, 64, 4, 4, 64, True, False, False),
    "mha_hd64_full_packed": (1, 64, 2, 2, 64, False, False, False),
    "mha_hd128": (1, 64, 2, 2, 128, True, False, False),
    "gqa4_hd128": (1, 64, 8, 2, 128, True, False, False),
    "gqa4_hd64_full": (1, 48, 4, 1, 64, False, False, False),
    "key_mask_causal": (2, 40, 4, 4, 64, True, False, True),
    "alibi_causal_gqa2": (1, 48, 4, 2, 64, True, True, False),
    "alibi_mask_full": (2, 40, 4, 2, 64, False, True, True),
    "ragged_gqa4_hd128": (1, 37, 8, 2, 128, True, False, False),
}


def _inputs(seed, B, S, H, KV, Hd, alibi, mask):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, S, H, Hd)).astype(np.float32)
    k = r.normal(size=(B, S, KV, Hd)).astype(np.float32)
    v = r.normal(size=(B, S, KV, Hd)).astype(np.float32)
    do = r.normal(size=(B, S, H, Hd)).astype(np.float32)
    slopes = r.uniform(0.05, 0.4, size=H).astype(np.float32) if alibi else None
    bias = None
    if mask:
        keep = r.random((B, S)) > 0.25
        keep[:, 0] = True
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, do, slopes, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(name):
    B, S, H, KV, Hd, causal, alibi, mask = CASES[name]
    q, k, v, do, slopes, bias = _inputs(sorted(CASES).index(name), B, S, H, KV, Hd, alibi, mask)

    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, mask_bias=_j(bias), causal=causal,
                      alibi_slopes=_j(slopes), interpret=True)
        return jnp.sum(o * _j(do))

    want = jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    kw = dict(mask_bias=_t(bias), causal=causal, alibi_slopes=_t(slopes))
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), **kw)
    delta = (_t(do) * o).sum(-1).transpose(1, 2).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), lse, delta)
    dq = fa.flash_attention_dq_plain(*args, **kw)
    dk, dv = fa.flash_attention_dkv_plain(*args, **kw)
    assert dq.shape == (B, S, H, Hd) and dk.shape == dv.shape == (B, S, KV, Hd)
    for got, w in zip((dq, dk, dv), want):
        assert _rel(got.numpy(), w) <= TOL


@pytest.mark.parametrize("causal,alibi,mask", [(True, False, False), (False, True, True)])
def test_autograd_function_matches_autograd_through_plain(causal, alibi, mask):
    """flash_attention's backward (the dq / dkv dispatch) against autograd
    through the plain forward, including a fully masked key row."""
    q, k, v, do, slopes, bias = _inputs(3, 2, 33, 4, 2, 64, alibi, mask)
    if mask:
        bias[1] = -1e30          # every key of batch row 1 masked: no mass anywhere
    kw = dict(mask_bias=_t(bias), causal=causal, alibi_slopes=_t(slopes))
    leaves = [_t(x).clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, _t(do))
    ref_o, _ = fa.flash_attention_plain(*leaves, **kw)
    want = torch.autograd.grad(ref_o, leaves, _t(do))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), w.numpy()) <= TOL
    if mask:
        assert not got[0][1].any() and not got[1][1].any() and not got[2][1].any()


def test_differentiable_lse_refused():
    q = torch.zeros((1, 16, 2, 64), requires_grad=True)
    with pytest.raises(NotImplementedError, match="return_lse"):
        fa.flash_attention(q, q, q, return_lse=True)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, q, q, return_lse=True)
    assert lse.shape == (1, 2, 16)
