"""The port's flash-attention backward against the JAX package's.

The port's plain dq / dk / dv (the math kernels C and D run on the card)
from its forward's o and lse, against ``jax.grad`` through the JAX
package's Pallas kernels in interpret mode: the packed-heads kernels (K2)
for MHA at Hd = 64 with no mask, ALiBi or padding, the general kernels (K1)
otherwise. Same seeded numpy inputs, fp32; gradients agree within 1e-5 of
each tensor's largest value (the fp32 sums run in other orders). So do the
gradients through a differentiable lse (``return_lse=True``), with and
without a block layout. The autograd Function is held to
``torch.autograd`` through the plain forward.
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


# (B, S, H, KV, Hd, causal, alibi, mask, layout): layout "random16" is a
# random [H, S/16, S/16] block layout, "+dead" with head 0's row block 1 empty
LSE_CASES = {
    "dense_causal": (2, 64, 4, 4, 64, True, False, False, None),
    "gqa4_hd128": (1, 64, 8, 2, 128, True, False, False, None),
    "alibi_mask_full_gqa2": (2, 40, 4, 2, 64, False, True, True, None),
    "layout_gqa2": (1, 64, 2, 1, 32, False, False, False, "random16"),
    "layout_dead_row": (1, 64, 2, 1, 32, True, False, False, "random16+dead"),
}


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_lse_gradients_match_jax_grad(name):
    """The gradients of sum(o * go) + sum(lse * glse) in q, k and v (the lse
    cotangent folded into C's and D's row term) against jax.grad of the JAX
    kernels' return_lse=True in interpret mode, within 1e-5 of each
    gradient's largest value. A row the layout leaves no key (lse = +1e30)
    drops its lse cotangent in both packages."""
    B, S, H, KV, Hd, causal, alibi, mask, layout = LSE_CASES[name]
    seed = 40 + sorted(LSE_CASES).index(name)
    q, k, v, go, slopes, bias = _inputs(seed, B, S, H, KV, Hd, alibi, mask)
    r = np.random.default_rng(seed)
    glse = r.normal(size=(B, H, S)).astype(np.float32)
    lay = None
    if layout is not None:
        lay = (r.random((H, S // 16, S // 16)) > 0.5).astype(np.int64)
        if layout.endswith("+dead"):
            lay[0, 1] = 0

    def f(q_, k_, v_):
        o, lse = jax_flash(q_, k_, v_, mask_bias=_j(bias), causal=causal,
                           alibi_slopes=_j(slopes), block_layout=_j(lay), interpret=True,
                           return_lse=True)
        return jnp.sum(o * _j(go)) + jnp.sum(lse * _j(glse))

    want = jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).clone().requires_grad_() for x in (q, k, v)]
    o, lse = fa.flash_attention(*leaves, mask_bias=_t(bias), causal=causal,
                                alibi_slopes=_t(slopes), block_layout=_t(lay), return_lse=True)
    got = torch.autograd.grad((o, lse), leaves, (_t(go), _t(glse)), retain_graph=True)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), w) <= TOL
    if layout is not None and layout.endswith("+dead"):
        assert bool((lse[:, 0, 16:32] == 1e30).all())
        assert not got[0][:, 16:32, 0].any()
    # the lse cotangent moves dq and dk (dv = p^T do does not see it):
    # leaving it out is a fault these tolerances see
    without = torch.autograd.grad(o, leaves, _t(go))
    assert all(_rel(a.numpy(), b.numpy()) > 1e-2 for a, b in zip(without[:2], got[:2]))
    assert _rel(without[2].numpy(), got[2].numpy()) <= TOL


def test_return_lse_is_differentiable():
    """return_lse=True on tensors that need a gradient runs the two-output
    Function (its backward through the dq / dkv dispatch); without a
    gradient it is the forward alone. An lse cotangent on its own (o
    unused) reaches q, k and v."""
    q = torch.randn((1, 16, 2, 64), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    o, lse = fa.flash_attention(q, q, q, return_lse=True)
    assert o.requires_grad and lse.requires_grad and lse.shape == (1, 2, 16)
    (g,) = torch.autograd.grad(lse.sum(), q)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    with torch.no_grad():
        o2, lse2 = fa.flash_attention(q, q, q, return_lse=True)
    assert not lse2.requires_grad
    assert torch.equal(o2, o.detach()) and torch.equal(lse2, lse.detach())
