"""Int8 weight-only quantization in the port (``ops/quant.py``,
``runtime/weight_quantizer.py``, the ``Quantized8`` leaves of
``checkpoint/from_jax.py``) against the JAX package's
(``deepspeed_tpu/ops/quant.py``, ``runtime/weight_quantizer.py``) on the
same numpy inputs: payloads and scales bit-equal, the dequantized matrix
bit-equal in fp32 and bf16 (one fp32 product, one rounding), byte counts
equal, and JAX trees with int8 nodes carried across both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu.runtime.weight_quantizer import WeightQuantization as JaxWeightQuantization
from deepspeed_tpu_torch.checkpoint.from_jax import (QuantizedArrays, params_from_jax,
                                                     params_to_jax)
from deepspeed_tpu_torch.models import ParamTree, TransformerConfig
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops.kernels import dequant_int8 as dq
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LLAMA = dict(vocab_size=64, max_seq=128, n_layer=2, n_head=2, n_kv_head=1, d_model=64,
             d_ff=128, pos_embedding="rope", norm="rmsnorm", activation="swiglu",
             tie_embeddings=False, norm_eps=1e-6)


def _bits(a):
    """The bit patterns of a torch or numpy array (16-bit floats as int16)."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy() if a.element_size() == 2 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _weights(seed, shape):
    r = np.random.default_rng(seed)
    w = (r.normal(size=shape) * 0.05).astype(np.float32)
    w[..., :3] *= 40.0                 # a few outlier columns, so groups differ
    w[0, :] = 0.0                      # an all-zero row: scale 1 in every group
    return w


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("shape", [(48, 64), (3, 16, 32)])
def test_quantize_int8_and_dequant_bit_equal_to_jax(groups, shape):
    w = _weights(groups + len(shape), shape)
    jq = jquant.quantize_int8(jnp.asarray(w), groups)
    pq = quant.quantize_int8(torch.from_numpy(w), groups)
    assert pq.q.dtype == torch.int8 and pq.scale.dtype == torch.float32
    assert tuple(pq.scale.shape) == shape[:-1] + (groups,)
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))
    assert pq.nbytes == jq.nbytes
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = pq.dequant(tdt)
        assert got.dtype == tdt
        want = np.asarray(jq.dequant(jdt))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_quantize_int8_refuses_groups_that_do_not_divide():
    with pytest.raises(ValueError, match="q_groups"):
        quant.quantize_int8(torch.zeros(4, 10), 3)


def test_maybe_dequant_passes_dense_weights_through():
    w = torch.randn(4, 8)
    assert quant.maybe_dequant(w) is w
    q8 = quant.quantize_int8(w, 2)
    assert torch.equal(quant.maybe_dequant(q8, torch.float32),
                       dq.dequant_int8_plain(q8.q, q8.scale, torch.float32))


def _jax_tree(seed=3):
    jcfg = JT.TransformerConfig(remat=False, attention_backend="xla", **LLAMA)
    return jcfg, jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(seed)))


def _leaves(tree):
    """(path, numpy) of every leaf of a port tree (nested dict) or a JAX
    tree, Quantized8 nodes as their q and scale."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif hasattr(x, "q") and hasattr(x, "scale"):
            out.append((path + ".q", np.asarray(x.q.detach() if torch.is_tensor(x.q) else x.q)))
            out.append((path + ".scale",
                        np.asarray(x.scale.detach() if torch.is_tensor(x.scale) else x.scale)))
        else:
            out.append((path, np.asarray(x.detach() if torch.is_tensor(x) else x)))

    walk(tree, "")
    return out


def _stacked(port_tree):
    """The port's per-layer tree stacked to the JAX layout (Quantized8 nodes
    as QuantizedArrays), for a leaf-by-leaf comparison."""
    cfg = TransformerConfig(**LLAMA)
    return params_to_jax(cfg, port_tree)


@pytest.mark.parametrize("groups,include_embed", [(1, False), (4, True)])
def test_quantize_params_bit_equal_to_jax(groups, include_embed):
    jcfg, jparams = _jax_tree()
    want = jquant.quantize_params(jparams, groups, include_embed)
    got = quant.quantize_params(params_from_jax(TransformerConfig(**LLAMA), jparams), groups,
                                include_embed)
    assert isinstance(got, ParamTree)
    assert isinstance(got["layers"][0]["attn"]["wq"], quant.Quantized8)
    assert isinstance(got["lm_head"], quant.Quantized8) == include_embed
    assert not isinstance(got["embed"]["tokens"], quant.Quantized8)
    g, w = _leaves(_stacked(got)), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype or (a.dtype == np.float32 and b.dtype == np.float32), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert quant.tree_nbytes(got) == jquant.tree_nbytes(want)


@pytest.mark.parametrize("mlp_extra_grouping", [True, False])
def test_weight_quantization_bit_equal_to_jax(mlp_extra_grouping):
    jcfg, jparams = _jax_tree(5)
    want = JaxWeightQuantization(mlp_extra_grouping).quantize_params(
        jparams, 8, groups=4, include_head=True)
    got = WeightQuantization(mlp_extra_grouping).quantize_params(
        params_from_jax(TransformerConfig(**LLAMA), jparams), 8, groups=4, include_head=True)
    assert got["layers"][1]["mlp"]["w_up"].scale.shape[-1] == (8 if mlp_extra_grouping else 4)
    assert got["layers"][1]["attn"]["wo"].scale.shape[-1] == 4
    for (path, a), (_, b) in zip(_leaves(_stacked(got)), _leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    with pytest.raises(NotImplementedError, match="8 bits"):
        WeightQuantization().quantize_params(got, 4)


def test_int8_nodes_round_trip_through_the_jax_bridge():
    """A JAX tree with Quantized8 nodes (stacked ``[L, in, out]`` payloads,
    ``[L, in, groups]`` scales) splits into per-layer Quantized8 leaves equal
    to quantizing each layer alone, and stacks back bit for bit."""
    jcfg, jparams = _jax_tree(9)
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jparams, 4, include_embed=True))
    assert isinstance(jq["layers"]["attn"]["wq"], jquant.Quantized8)
    cfg = TransformerConfig(**LLAMA)
    port = params_from_jax(cfg, jq)
    wq = port["layers"][1]["attn"]["wq"]
    assert isinstance(wq, quant.Quantized8) and tuple(wq.shape) == (64, 64)
    alone = quant.quantize_int8(torch.from_numpy(np.array(jparams["layers"]["attn"]["wq"][1])),
                                4)
    assert torch.equal(wq.q, alone.q) and torch.equal(wq.scale, alone.scale)
    assert isinstance(port["lm_head"], quant.Quantized8)
    back = params_to_jax(cfg, port)
    assert isinstance(back["layers"]["attn"]["wq"], QuantizedArrays)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(jq)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    # rebuilt as the JAX package's nodes, the tree dequantizes as the original
    rebuilt = jax.tree.map(lambda x: jquant.Quantized8(q=x.q, scale=x.scale)
                           if isinstance(x, QuantizedArrays) else x, back,
                           is_leaf=lambda x: isinstance(x, QuantizedArrays))
    np.testing.assert_array_equal(
        np.asarray(rebuilt["layers"]["mlp"]["w_down"].dequant(jnp.float32)),
        np.asarray(jquant.quantize_params(jparams, 4)["layers"]["mlp"]["w_down"]
                   .dequant(jnp.float32)))
