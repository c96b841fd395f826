"""The port's architecture presets against the JAX package's: every preset
and size builds a ``TransformerConfig`` equal to the JAX one field for field,
``get_model`` and ``MODEL_PRESETS`` resolve the same way, and the bloom, opt
and gpt_neox shapes (ALiBi with the embedding layernorm, relu with learned
positions, parallel residual with biases) cut to 2 layers at d_model 64
give the JAX package's logits, through ``CausalLM.forward`` with the same
weights, within ``test_torch_model.py``'s tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import presets as jp
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import CausalLM, presets as pp
from tests.test_torch_model import TOL, _jax_params

SIZES = {
    "gpt2": ["125m", "350m", "774m", "1.5b"],
    "llama": ["tiny", "7b", "13b", "70b"],
    "bloom": ["560m", "1b7", "7b1", "176b"],
    "opt": ["125m", "1.3b", "6.7b", "13b", "30b", "66b"],
    "gpt_neox": ["tiny", "20b"],
}
TINY = dict(n_layer=2, n_head=4, d_model=64, vocab_size=128, max_seq=32, remat=False)


def _fields(model):
    return dataclasses.asdict(model.config)


@pytest.mark.parametrize("family,size", [(f, s) for f, sizes in SIZES.items() for s in sizes])
def test_preset_configs_match_the_jax_package(family, size):
    assert _fields(pp.get_model(family, size)) == _fields(jp.get_model(family, size))


@pytest.mark.parametrize("name", ["gpt2_medium", "gpt2_large", "gpt2_xl", "llama_7b"])
def test_named_presets_match_the_jax_package(name):
    assert _fields(getattr(pp, name)()) == _fields(getattr(jp, name)())
    over = {"remat": False, "dropout": 0.1}
    assert _fields(getattr(pp, name)(**over)) == _fields(getattr(jp, name)(**over))


def test_get_model_defaults_and_families():
    assert sorted(pp.MODEL_PRESETS) == sorted(jp.MODEL_PRESETS)
    for family in pp.MODEL_PRESETS:
        assert _fields(pp.get_model(family)) == _fields(jp.get_model(family))
    assert isinstance(pp.get_model("opt", "125m", remat=False), CausalLM)
    for mod in (pp, jp):       # the fixed fields of a preset are not overrides (but llama's)
        with pytest.raises(TypeError, match="vocab_size"):
            mod.get_model("opt", "125m", vocab_size=64)
    assert pp.get_model("llama", "7b", n_layer=2).config.n_layer == 2
    with pytest.raises(KeyError):
        pp.get_model("t5")


@pytest.mark.parametrize("family", ["bloom", "opt", "gpt_neox"])
def test_tiny_preset_forward_matches_the_jax_logits(family):
    jcfg = dataclasses.replace(jp.get_model(family).config, **TINY)
    pcfg = dataclasses.replace(pp.get_model(family).config, **TINY)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    tree = _jax_params(jcfg, 7)
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (2, 24)).astype(np.int32)
    want = JaxCausalLM(jcfg).forward(tree, jnp.asarray(tokens))
    with torch.no_grad():
        got = CausalLM(pcfg).forward(params_from_jax(pcfg, tree), torch.from_numpy(tokens).long())
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    assert got.shape == want.shape == (2, 24, TINY["vocab_size"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.abs(want).max() > 10 * TOL
    jax.clear_caches()
