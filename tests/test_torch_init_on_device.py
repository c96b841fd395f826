"""``OnDevice`` (``deepspeed_tpu_torch/utils/init_on_device.py``) against the
JAX package's: under ``device="meta"`` every model family's ``init_params``
gives a tree of meta tensors (no storage) whose shapes and dtypes, with the
port's per-layer leaves stacked as the JAX package stacks them, equal the
JAX ``jax.eval_shape`` tree's; the dtype override casts every floating leaf,
on the meta device and in a normal init; outside the context nothing
changes; the context is thread-local; only the JAX package's device values
are accepted."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import clip as jclip
from deepspeed_tpu.models import moe_lm as jmoe_lm
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxTConfig
from deepspeed_tpu.moe import MoE as JaxMoE
from deepspeed_tpu.ops.transformer import training_kernels as jtk
from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JaxTiledLinear
from deepspeed_tpu_torch import OnDevice
from deepspeed_tpu_torch.models import bert as pbert
from deepspeed_tpu_torch.models import clip as pclip
from deepspeed_tpu_torch.models import moe_lm as pmoe_lm
from deepspeed_tpu_torch.models.causal_lm import CausalLM
from deepspeed_tpu_torch.models.presets import llama
from deepspeed_tpu_torch.models.transformer import ParamTree, TransformerConfig
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.ops.transformer import training_kernels as ptk
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LM = dict(vocab_size=64, n_layer=3, n_head=2, d_model=16, d_ff=32, max_seq=16)
BERT = dict(vocab_size=64, max_seq=16, n_layer=2, n_head=2, d_model=16, d_ff=32)
TEXT = dict(vocab_size=50, max_seq=8, n_layer=2, n_head=2, d_model=16, d_ff=32,
            projection_dim=8)
VISION = dict(image_size=16, patch_size=8, n_layer=2, n_head=2, d_model=16, d_ff=32,
              projection_dim=8)
LAYER = dict(batch_size=1, hidden_size=16, heads=2, intermediate_size=32, seq_length=8)

# (name, the JAX model, the port model): every params-producing entry of the port
FAMILIES = {
    "causal_lm": lambda: (JaxCausalLM(JaxTConfig(**LM)), CausalLM(TransformerConfig(**LM))),
    "moe_lm": lambda: (jmoe_lm.MoECausalLM(JaxTConfig(**LM), jmoe_lm.MoEConfig(num_experts=2)),
                       pmoe_lm.MoECausalLM(TransformerConfig(**LM),
                                           pmoe_lm.MoEConfig(num_experts=2))),
    "bert": lambda: (jbert.BertModel(jbert.BertConfig(**BERT), with_mlm_head=True),
                     pbert.BertModel(pbert.BertConfig(**BERT), with_mlm_head=True)),
    "clip_text": lambda: (jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**TEXT)),
                          pclip.CLIPTextEncoder(pclip.CLIPTextConfig(**TEXT))),
    "clip_vision": lambda: (jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**VISION)),
                            pclip.CLIPVisionEncoder(pclip.CLIPVisionConfig(**VISION))),
    "moe_layer": lambda: (JaxMoE(16, num_experts=2, use_residual=True),
                          MoE(16, num_experts=2, use_residual=True)),
    "transformer_layer": lambda: (
        jtk.DeepSpeedTransformerLayer(jtk.DeepSpeedTransformerConfig(**LAYER)),
        ptk.DeepSpeedTransformerLayer(ptk.DeepSpeedTransformerConfig(**LAYER))),
    "tiled_linear": lambda: (JaxTiledLinear(16, 24, 2, 3), TiledLinear(16, 24, 2, 3)),
}


def _flat(tree, prefix=()):
    """The port's tree as {path: tensor}, list positions as ints."""
    if isinstance(tree, ParamTree):
        tree = tree.to_dict()
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, prefix + (i,)).items()}
    return {prefix: tree}


def _stacked(port_tree):
    """{JAX path: (shape, dtype name)}: the per-layer leaves
    (``layers.<i>.…``) stacked into one ``[n_layer, ...]`` leaf, as the JAX
    package keeps them."""
    out, counts = {}, {}
    for path, t in _flat(port_tree).items():
        dtype = str(t.dtype).split(".")[-1]
        if len(path) > 1 and isinstance(path[1], int):
            key = (path[0],) + path[2:]
            counts[key] = counts.get(key, 0) + 1
            out[key] = (tuple(t.shape), dtype)
        else:
            out[path] = (tuple(t.shape), dtype)
    return {k: ((counts[k],) + s, d) if k in counts else (s, d) for k, (s, d) in out.items()}


def _jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(p.key for p in path): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for path, x in flat}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_meta_tree_matches_jax_eval_shape(family, dtype):
    jm, pm = FAMILIES[family]()
    with deepspeed_tpu.OnDevice(dtype=dtype and jnp.bfloat16, device="meta"):
        want = jm.init_params(jax.random.key(0))
    assert all(isinstance(x, jax.ShapeDtypeStruct) for x in jax.tree.leaves(want))
    with OnDevice(dtype=dtype and torch.bfloat16, device="meta"):
        got = pm.init_params(torch.Generator().manual_seed(0))
    leaves = list(_flat(got).values())
    assert leaves and all(t.is_meta for t in leaves)
    assert _stacked(got) == _jax_shapes(want)


def test_meta_init_allocates_nothing():
    """Llama-2-7B's 6.74 B parameters (27 GB in fp32) as meta tensors: no
    storage behind any of them."""
    model = llama("7b")
    with OnDevice(device="meta"):
        params = model.init_params()
    leaves = list(params.parameters())
    assert sum(p.numel() for p in leaves) == model.num_parameters
    assert all(p.is_meta and p.data_ptr() == 0 for p in leaves)


def test_device_init_with_dtype_cast():
    """``device="device"``: a normal init (real CPU tensors here), every
    floating leaf cast; the same draws as without the context."""
    model = CausalLM(TransformerConfig(**LM))
    with OnDevice(dtype=torch.bfloat16):
        params = model.init_params(torch.Generator().manual_seed(0))
    plain = model.init_params(torch.Generator().manual_seed(0))
    for (n, p), (_, q) in zip(params.named_parameters(), plain.named_parameters()):
        assert p.device.type == "cpu" and p.dtype == torch.bfloat16, n
        assert torch.equal(p, q.to(torch.bfloat16)), n


def test_outside_context_is_untouched():
    model = CausalLM(TransformerConfig(**LM))
    params = model.init_params(torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in params.parameters())
    assert OnDevice.current() is None


def test_disabled_context_keeps_the_outer_one():
    with OnDevice(device="meta") as outer:
        with OnDevice(dtype=torch.bfloat16, enabled=False):
            assert OnDevice.current() is outer
            p = TiledLinear(8, 8).init_params()
        assert OnDevice.current() is outer
    assert p["w"].is_meta and p["w"].dtype == torch.float32


def test_context_is_thread_local():
    seen = {}

    def other():
        seen["ctx"] = OnDevice.current()
        seen["w"] = TiledLinear(8, 8).init_params()["w"]

    with OnDevice(device="meta"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert OnDevice.current() is not None
    assert seen["ctx"] is None and not seen["w"].is_meta


@pytest.mark.parametrize("device", ["cuda:0", "cpu", "cuda"])
def test_invalid_device_rejected_like_jax(device):
    with pytest.raises(ValueError, match="meta"):
        deepspeed_tpu.OnDevice(device=device)
    with pytest.raises(ValueError, match="meta"):
        OnDevice(device=device)


def test_exported_at_the_package_root():
    assert deepspeed_tpu_torch.OnDevice is OnDevice
    np.testing.assert_equal(OnDevice().device, deepspeed_tpu.OnDevice().device)
