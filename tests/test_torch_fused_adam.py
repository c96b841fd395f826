"""The port's fused Adam (plain version, the math kernel E runs on the
card) against the JAX package's Pallas ``_adam_kernel`` in interpret mode:
emit param / update, AdamW and L2 Adam, weight decay on and off, bias
correction on and off, ragged lengths. Same seeded numpy inputs, fp32, one
step from nonzero moments; agreement within 1e-6 of each output's largest
value (the two run the same fp32 operations, which XLA may fuse). The CUDA
kernel is held to the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.fused_adam_kernel import _run_adam
from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad

TOL = 1e-6
GRID = list(itertools.product(("param", "update"), (True, False), (0.0, 0.1), (True, False)))


@pytest.mark.parametrize("emit,adam_w,wd,bias_correction", GRID)
def test_plain_matches_jax_kernel(emit, adam_w, wd, bias_correction):
    n = 1000 + 37 * GRID.index((emit, adam_w, wd, bias_correction))   # ragged lengths
    r = np.random.default_rng(n)
    p = r.normal(size=n).astype(np.float32)
    g = r.normal(size=n).astype(np.float32)
    m = (r.normal(size=n) * 0.1).astype(np.float32)
    v = (r.normal(size=n) ** 2 * 0.01).astype(np.float32)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, adam_w_mode=adam_w,
              bias_correction=bias_correction)
    want = _run_adam(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), step=3,
                     interpret=True, emit=emit, **kw)
    mt, vt = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    out = fad.fused_adam_step(torch.from_numpy(p), torch.from_numpy(g), mt, vt, step=3,
                              emit=emit, **kw)
    for got, w in zip((out, mt, vt), want):          # m and v are updated in place
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= TOL * np.abs(w).max()


def test_param_in_place_and_dtypes():
    """emit="param" may write the new param over p; a bf16 p comes back in
    bf16 from fp32 math; the moments stay fp32."""
    r = np.random.default_rng(0)
    p = torch.from_numpy(r.normal(size=257).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(r.normal(size=257).astype(np.float32))
    m, v = torch.zeros(257), torch.zeros(257)
    ref, rm, rv = fad.fused_adam_plain(p, g, m.clone(), v.clone(), 1e-3,
                                       *fad.bias_corrections(1, 0.9, 0.999), b1=0.9, b2=0.999,
                                       eps=1e-8, weight_decay=0.0, adam_w_mode=True, emit="param")
    out = fad.fused_adam_step(p, g, m, v, step=1, lr=1e-3, out=p)
    assert out is p and p.dtype == torch.bfloat16 and torch.equal(p, ref)
    assert torch.equal(m, rm) and torch.equal(v, rv) and m.dtype == torch.float32


def test_bias_corrections_in_fp32():
    bc1, bc2 = fad.bias_corrections(7, 0.9, 0.95)
    assert bc1 == float(np.float32(1) - np.float32(0.9) ** np.float32(7))
    assert bc2 == float(np.float32(1) - np.float32(0.95) ** np.float32(7))
    assert fad.bias_corrections(7, 0.9, 0.95, bias_correction=False) == (1.0, 1.0)


def test_wrapper_refuses_other_devices_and_emits():
    x = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fad.fused_adam_step(x, x, x, x, step=1)
    y = torch.zeros(16)
    with pytest.raises(ValueError, match="emit"):
        fad.fused_adam_step(y, y, y, y, step=1, emit="both")
