"""``TiledLinear`` (``deepspeed_tpu_torch/runtime/zero/tiling.py``) against
the JAX package's: the tiled tree round-trips a dense weight exactly and
is the JAX ``from_dense`` tree; both lowerings (one einsum, the loop over
out-rows of tiles) compute the JAX forward on the JAX parameters, loaded
unchanged, within ``RTOL`` in fp32; the gradients of x, the tiles and the
bias equal the dense product's autograd within ``RTOL``; uneven splits
raise the JAX ``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JaxTiledLinear
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

RTOL = 1e-5        # fp32, relative to the output's largest value: summation order only
SHAPES = [(16, 24, 2, 3), (12, 20, 3, 4), (8, 8, 1, 1)]


def _close(got, want):
    got = np.asarray(torch.as_tensor(got).detach().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-30)


def _inputs(din, dout, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((3, 5, din)).astype(np.float32),
            (r.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32),
            r.standard_normal(dout).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_from_dense_round_trips_and_is_the_jax_tree(shape):
    din, dout, si, so = shape
    _, w, b = _inputs(din, dout)
    tl, jtl = TiledLinear(din, dout, si, so), JaxTiledLinear(din, dout, si, so)
    p = tl.from_dense(torch.from_numpy(w), torch.from_numpy(b))
    jp = jtl.from_dense(w, b)
    assert torch.equal(tl.to_dense(p), torch.from_numpy(w))
    assert set(p) == set(jp)
    for k in jp:
        assert np.array_equal(p[k].numpy(), np.asarray(jp[k])), k
    assert np.array_equal(tl.to_dense(p).numpy(), np.asarray(jtl.to_dense(jp)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_forward_matches_jax_on_jax_params(shape, scan, bias):
    """The JAX params (a seeded ``init_params``, a random bias) load
    unchanged: each leaf ``torch.as_tensor`` of its numpy array."""
    din, dout, si, so = shape
    x, _, b = _inputs(din, dout, seed=1)
    jtl = JaxTiledLinear(din, dout, si, so, bias=bias, scan_tiles=scan)
    jp = jtl.init_params(jax.random.key(3))
    if bias:
        jp["b"] = jnp.asarray(b)
    want = np.asarray(jtl(jp, jnp.asarray(x)))
    tl = TiledLinear(din, dout, si, so, bias=bias, scan_tiles=scan)
    p = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    _close(tl(p, torch.from_numpy(x)), want)


@pytest.mark.parametrize("scan", [False, True])
def test_gradients_match_the_dense_product(scan):
    din, dout, si, so = 16, 24, 2, 3
    x, w, b = _inputs(din, dout, seed=2)
    dy = np.random.default_rng(5).standard_normal((3, 5, dout)).astype(np.float32)
    tl = TiledLinear(din, dout, si, so, scan_tiles=scan)
    p = {k: v.clone().requires_grad_() for k, v in
         tl.from_dense(torch.from_numpy(w), torch.from_numpy(b)).items()}
    xt = torch.from_numpy(x).requires_grad_()
    tl(p, xt).backward(torch.from_numpy(dy))
    xd = torch.from_numpy(x).requires_grad_()
    wd = torch.from_numpy(w).requires_grad_()
    bd = torch.from_numpy(b).requires_grad_()
    (xd @ wd + bd).backward(torch.from_numpy(dy))
    _close(xt.grad, xd.grad.numpy())
    _close(tl.to_dense({"w": p["w"].grad}), wd.grad.numpy())
    _close(p["b"].grad, bd.grad.numpy())


@pytest.mark.parametrize("shape", [(10, 24, 3, 3), (16, 25, 2, 3)])
def test_uneven_splits_raise_like_jax(shape):
    with pytest.raises(ValueError) as want:
        JaxTiledLinear(*shape)
    with pytest.raises(ValueError) as got:
        TiledLinear(*shape)
    assert str(got.value) == str(want.value)


def test_from_dense_checks_like_jax():
    tl, jtl = TiledLinear(8, 12, 2, 3), JaxTiledLinear(8, 12, 2, 3)
    for call in (lambda m: m.from_dense(np.zeros((12, 8), np.float32)),
                 lambda m: m.from_dense(np.zeros((8, 12), np.float32))):
        with pytest.raises(ValueError) as want:
            call(jtl)
        with pytest.raises(ValueError) as got:
            call(tl)
        assert str(got.value) == str(want.value)


def test_init_params_layout_matches_jax():
    tl, jtl = TiledLinear(16, 24, 2, 3), JaxTiledLinear(16, 24, 2, 3)
    p = tl.init_params(torch.Generator().manual_seed(0))
    jp = jtl.init_params(jax.random.key(0))
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == torch.float32
    assert not p["b"].any()
    # N(0, 1/in): the draw's spread within a few standard errors of 16**-0.5
    assert abs(float(p["w"].std()) - 0.25) < 0.05
