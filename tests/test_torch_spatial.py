"""The NHWC bias adds (``deepspeed_tpu_torch/ops/spatial/kernels.py``)
against the JAX package's ``ops/spatial/kernels.py``: each of the three
forms on the same seeded inputs, in bf16 and fp32, bit for bit (limit 0:
the plain version is the torch chain of adds, each rounded to the dtype,
which is kernel S's order too). The wrappers take the plain version for
CPU tensors only and refuse any other device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.spatial import kernels as jsk
from deepspeed_tpu_torch.ops.spatial import kernels as sk

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

FORMS = {"nhwc_bias_add": 2, "nhwc_bias_add_add": 3, "nhwc_bias_add_bias_add": 4}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}
SHAPES = [(2, 8, 8, 320), (1, 5, 7, 24), (3, 4, 16)]


def _inputs(shape, n_args, seed):
    r = np.random.default_rng(seed)
    C = shape[-1]
    full = lambda: r.standard_normal(shape).astype(np.float32) * 3
    vec = lambda: r.standard_normal(C).astype(np.float32)
    return [full(), vec(), full(), vec()][:n_args]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_bit_for_bit(form, dtype, shape):
    tdt, jdt = DTYPES[dtype]
    args = _inputs(shape, FORMS[form], seed=len(shape) * 7 + FORMS[form])
    want = getattr(jsk, form)(*(jnp.asarray(a).astype(jdt) for a in args))
    got = getattr(sk, form)(*(torch.from_numpy(a).to(tdt) for a in args))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    g = got.view(torch.int16 if got.element_size() == 2 else torch.int32).numpy()
    assert np.array_equal(g.view(_bits(want).dtype), _bits(want))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_version_is_the_chain(form):
    """The plain twin rounds after every add (the order S keeps): at bf16
    the chain differs from one fp32 sum rounded once on some elements."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((2, 8, 8, 320), FORMS[form], 1)]
    got = getattr(sk, form)(*args)
    assert torch.equal(got, getattr(sk, form + "_plain")(*args))
    if FORMS[form] > 2:
        once = sum(a.float() for a in args).to(torch.bfloat16)
        assert not torch.equal(got, once)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_other_devices_are_refused(form):
    args = [torch.empty((1, 2, 2, 8), device="meta") if i % 2 == 0
            else torch.empty((8,), device="meta") for i in range(FORMS[form])]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        getattr(sk, form)(*args)
