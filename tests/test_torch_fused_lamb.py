"""The port's fused LAMB (the plain versions, the math the K7 kernels run on
the card) against the JAX package's Pallas ``_lamb_kernel`` in interpret
mode: ragged and tile-multiple lengths, weight decay on and off, bias
correction on and off, and the zero-norm ratio of 1. Same seeded numpy
inputs, fp32, one step from nonzero moments. p, m and v agree within 1e-6
of each output's largest value and the ratio within 1e-6 relative (the
same fp32 operations; the norms are sums in another order, fp64 here). A
group of L flat leaves takes one ratio, equal to the JAX kernel's on the
stacked leaf; one ratio per leaf does not. The CUDA kernels are held to
these plain versions on the card by ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.lamb.fused_lamb_kernel import _run_lamb
from deepspeed_tpu.ops.lamb.fused_lamb_kernel import fused_lamb_step as jax_fused_lamb_step
from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl

TOL = 1e-6
RATIO_TOL = 1e-6
GRID = list(itertools.product((1000, 32768, 100000), (0.0, 0.01), (True, False)))


def _inputs(n, seed):
    r = np.random.default_rng(seed)
    p = (r.normal(size=n) * 0.02).astype(np.float32)
    g = (r.normal(size=n) * 1e-3).astype(np.float32)
    m = (r.normal(size=n) * 1e-4).astype(np.float32)
    v = (r.normal(size=n) ** 2 * 1e-7).astype(np.float32)
    return p, g, m, v


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("n,wd,bias_correction", GRID)
def test_plain_matches_jax_kernel(n, wd, bias_correction):
    p, g, m, v = _inputs(n, GRID.index((n, wd, bias_correction)))
    kw = dict(step=3, lr=1e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=wd,
              bias_correction=bias_correction)
    want = jax_fused_lamb_step(*(jnp.asarray(a) for a in (p, g, m, v)), interpret=True, **kw)
    mt, vt = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    new_p, mt2, vt2, ratio = fl.fused_lamb_step(torch.from_numpy(p), torch.from_numpy(g), mt,
                                                vt, **kw)
    assert mt2 is mt and vt2 is vt                  # moments updated in place
    for got, w in zip((new_p, mt, vt), want[:3]):
        assert _close(got.numpy(), w)
    assert abs(float(ratio) - float(want[3])) <= RATIO_TOL * float(want[3])
    assert float(ratio) != 1.0


def test_plain_flat_returns_the_jax_update():
    """``_plain_lamb_flat`` is the JAX ``_jnp_lamb_flat``: new p, m, v,
    ratio and the unscaled u."""
    p, g, m, v = _inputs(4099, 7)
    bc1, bc2 = fl.bias_corrections(2, 0.9, 0.999)
    want = _run_lamb(*(jnp.asarray(a) for a in (p, g, m, v)), step=2, lr=1e-3, b1=0.9,
                     b2=0.999, eps=1e-6, weight_decay=0.01, bias_correction=True,
                     interpret=True)
    got = fl._plain_lamb_flat(*(torch.from_numpy(a) for a in (p, g, m, v)), 1e-3, bc1, bc2,
                              b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    for i in (0, 1, 2, 4):
        assert _close(got[i].numpy(), want[i])
    assert abs(float(got[3]) - float(want[3])) <= RATIO_TOL * float(want[3])


@pytest.mark.parametrize("case", ["zero_params", "zero_update"])
def test_zero_norm_ratio_is_one(case):
    n = 2048
    p, g, m, v = _inputs(n, 11)
    if case == "zero_params":
        p[:] = 0.0
    else:
        g[:] = 0.0
        m[:] = 0.0
        v[:] = 0.0
    kw = dict(step=1, lr=1e-3, weight_decay=0.0)
    want = jax_fused_lamb_step(*(jnp.asarray(a) for a in (p, g, m, v)), interpret=True, **kw)
    got = fl.fused_lamb_step(*(torch.from_numpy(a.copy()) for a in (p, g, m, v)), **kw)
    assert float(got[3]) == float(want[3]) == 1.0
    assert _close(got[0].numpy(), want[0])


@pytest.mark.parametrize("L,shape", [(2, (128, 256)), (3, (257, 5)), (8, (64,))])
def test_group_ratio_equals_jax_on_the_stacked_leaf(L, shape):
    """L port leaves of one stacked JAX leaf ``[L, *shape]``: one ratio over
    the group, and every leaf's new p within TOL of the JAX kernel's."""
    n = int(np.prod(shape))
    p, g, m, v = _inputs(L * n, L + n)
    kw = dict(step=4, lr=2e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    want = jax_fused_lamb_step(*(jnp.asarray(a) for a in (p, g, m, v)), interpret=True, **kw)
    split = lambda a: [torch.from_numpy(a[i * n:(i + 1) * n].copy()) for i in range(L)]
    ps, gs, ms, vs = split(p), split(g), split(m), split(v)
    ratio = fl.lamb_group_step(ps, lambda i: gs[i], ms, vs, **kw)
    assert abs(float(ratio) - float(want[3])) <= RATIO_TOL * float(want[3])
    for got, w in ((ps, want[0]), (ms, want[1]), (vs, want[2])):
        assert _close(torch.cat(got).numpy(), w)
    # one ratio per port leaf is another function: it misses by far more
    per_leaf = [fl.fused_lamb_step(*(x[i] for x in (split(p), gs, split(m), split(v))), **kw)
                for i in range(L)]
    ratios = [float(r[3]) for r in per_leaf]
    assert max(abs(r - float(want[3])) for r in ratios) > 100 * RATIO_TOL * float(want[3])
    assert not _close(torch.cat([r[0] for r in per_leaf]).numpy(), want[0])


def test_group_step_takes_grads_as_a_list_or_a_function():
    p, g, m, v = _inputs(3000, 3)
    outs = []
    for as_fn in (False, True):
        ps = [torch.from_numpy(p[:1000].copy()), torch.from_numpy(p[1000:].copy())]
        gs = [torch.from_numpy(g[:1000]), torch.from_numpy(g[1000:])]
        ms = [torch.from_numpy(m[:1000].copy()), torch.from_numpy(m[1000:].copy())]
        vs = [torch.from_numpy(v[:1000].copy()), torch.from_numpy(v[1000:].copy())]
        r = fl.lamb_group_step(ps, gs.__getitem__ if as_fn else gs, ms, vs, step=1, lr=1e-3)
        outs.append((r, ps, ms, vs))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 2048, 2049, 1 << 20, 131072000])
def test_blocks_cover_the_leaf(n):
    """One block per 256 vectors of 8 (the scalar tail counts one each), at
    least one and at most eight an SM: the partial buffer's rows."""
    b = fl.lamb_blocks(n)
    assert 1 <= b <= 132 * 8
    assert b * 256 >= min(n // 8 + n % 8, 132 * 8 * 256)


def test_wrappers_refuse_other_devices_and_bad_partials():
    x = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fl.fused_lamb_step(x, x, x, x, step=1)
    y = torch.zeros(16)
    with pytest.raises(ValueError, match="partials"):
        fl.lamb_moments(y, y, y, y, torch.zeros((2, 2), dtype=torch.float64), bc1=1.0,
                        bc2=1.0, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0)
    with pytest.raises(ValueError, match="partials"):
        fl.lamb_ratio(torch.zeros((3, 2)))
