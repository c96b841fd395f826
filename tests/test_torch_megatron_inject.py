"""Megatron ds_inference checkpoint ingestion in the port
(``module_inject/megatron.py``, ``checkpoint/state_dict_factory.py``)
against the JAX package's on the same files.

The JAX package's round-trip fixture (its params -> per-TP-rank Megatron
files -> meta json) feeds both loaders: for fused-qkv layouts v0, v1.0 and
v2.0 at tp 1 and 2, the port's tree is bit-equal to ``params_from_jax`` of
the JAX loader's (and of the original params); the same over torch ``.pt``
rank files. The meta json (a path or a dict) serves through
``init_inference``: forward logits equal to the same params given directly
(bit for bit) and within ``TOL`` of the JAX engine's. ``quantize=True`` and
MoE expert keys raise naming their ROADMAP items; a meta json without a
model raises the JAX engine's ``ValueError``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

pytest.importorskip("safetensors")

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu.comm as jdist  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM  # noqa: E402
from deepspeed_tpu.module_inject.megatron import load_megatron_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax  # noqa: E402
from deepspeed_tpu_torch.models import CausalLM  # noqa: E402
from deepspeed_tpu_torch.models import TransformerConfig  # noqa: E402
from deepspeed_tpu_torch.module_inject.megatron import (load_megatron_checkpoint,  # noqa: E402
                                                        megatron_merge_strategies)
from tests.unit.test_megatron_inject import (_cfg, _shard_megatron_sd,  # noqa: E402
                                             _to_megatron_sd, _write_ckpt)

TOL = 1e-4          # fp32 logits, absolute (tests/test_torch_model.py)


@pytest.fixture(autouse=True)
def no_mesh():
    jdist.set_mesh(None)
    yield


def _params(seed):
    cfg = _cfg()
    return cfg, jax.tree.map(np.asarray, JaxCausalLM(cfg).init_params(jax.random.key(seed)))


def _pcfg(jcfg):
    import dataclasses
    return TransformerConfig(**dataclasses.asdict(jcfg))


def _named(tree):
    return dict(tree.named_parameters())


def _assert_tree_equal(got, want):
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
@pytest.mark.parametrize("tp", [1, 2])
def test_megatron_tree_is_the_jax_loaders(tmp_path, version, tp):
    jcfg, params = _params(0)
    ranks = _shard_megatron_sd(_to_megatron_sd(params, jcfg, version), tp, version)
    meta = _write_ckpt(tmp_path, ranks, version)
    pcfg = _pcfg(jcfg)
    got = load_megatron_checkpoint(meta, pcfg)
    jtree = jax.tree.map(np.asarray, jax_load(meta, jcfg))
    _assert_tree_equal(got, params_from_jax(pcfg, jtree))
    _assert_tree_equal(got, params_from_jax(pcfg, params))


@pytest.mark.parametrize("version", [0, 2.0])
def test_megatron_torch_rank_files(tmp_path, version):
    """Per-rank torch files (the SD loader's memory-mapped torch.load) give
    the original tree, and in bf16 that tree cast."""
    jcfg, params = _params(3)
    ranks = _shard_megatron_sd(_to_megatron_sd(params, jcfg, version), 2, version)
    names = []
    for i, sd in enumerate(ranks):
        names.append(f"mp_rank_{i:02d}_model_states.pt")
        torch.save({"module": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, tmp_path / names[-1])
    meta = {"type": "Megatron", "checkpoints": names, "base_dir": str(tmp_path),
            "version": version}
    pcfg = _pcfg(jcfg)
    _assert_tree_equal(load_megatron_checkpoint(meta, pcfg), params_from_jax(pcfg, params))
    bf16 = load_megatron_checkpoint(meta, pcfg, dtype=torch.bfloat16)
    want = _named(params_from_jax(pcfg, params))
    assert all(torch.equal(t, want[n].to(torch.bfloat16)) for n, t in _named(bf16).items())


@pytest.mark.parametrize("as_dict", [False, True])
def test_meta_json_serves_through_init_inference(tmp_path, as_dict):
    jcfg, params = _params(1)
    ranks = _shard_megatron_sd(_to_megatron_sd(params, jcfg, 2.0), 2, 2.0)
    meta = _write_ckpt(tmp_path, ranks, 2.0)
    if as_dict:
        with open(meta) as f:
            meta = json.load(f)
    model = CausalLM(_pcfg(jcfg))
    base = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                              params=params_from_jax(model.config, params))
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu", checkpoint=meta)
    toks = np.array([[1, 2, 3, 4]], np.int32)
    got = eng.forward(toks)
    assert torch.equal(got, base.forward(toks))
    jeng = deepspeed_tpu.init_inference(JaxCausalLM(jcfg), dtype="fp32", checkpoint=meta)
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.forward(jnp.asarray(toks))),
                               atol=TOL, rtol=0)


def test_meta_json_without_a_model_raises_like_jax(tmp_path):
    jcfg, params = _params(1)
    meta = _write_ckpt(tmp_path, _shard_megatron_sd(_to_megatron_sd(params, jcfg, 0), 1, 0), 0)
    with pytest.raises(ValueError, match="need the model"):
        deepspeed_tpu.init_inference(None, dtype="fp32", checkpoint=meta)
    with pytest.raises(ValueError, match="need the model"):
        deepspeed_tpu_torch.init_inference(None, dtype="fp32", device="cpu", checkpoint=meta)


def test_quantize_on_load_raises_naming_int8_inference(tmp_path):
    jcfg, params = _params(2)
    meta = _write_ckpt(tmp_path, _shard_megatron_sd(_to_megatron_sd(params, jcfg, 0), 2, 0), 0)
    with pytest.raises(NotImplementedError, match="int8 inference"):
        load_megatron_checkpoint(meta, _pcfg(jcfg), quantize=True, quantize_groups=4)


def test_moe_expert_keys_raise_naming_moe(tmp_path):
    jcfg, params = _params(2)
    sd = _to_megatron_sd(params, jcfg, 0)
    ex = "transformer.layers.0.mlp.deepspeed_moe.experts.deepspeed_experts.0"
    sd[ex + ".dense_h_to_4h.weight"] = np.zeros((64, 32), np.float32)
    meta = _write_ckpt(tmp_path, [sd], 0)
    with pytest.raises(NotImplementedError, match="MoE"):
        load_megatron_checkpoint(meta, _pcfg(jcfg))


def test_unknown_type_and_version_raise_like_jax(tmp_path):
    jcfg, params = _params(2)
    meta = _write_ckpt(tmp_path, [_to_megatron_sd(params, jcfg, 0)], 0)
    with open(meta) as f:
        data = json.load(f)
    for over, match in (({"type": "BLOOM"}, "unsupported ds_inference checkpoint type"),
                        ({"version": 3.0}, "unsupported Megatron checkpoint version")):
        bad = {**data, **over}
        with pytest.raises(ValueError, match=match):
            jax_load(bad, jcfg)
        with pytest.raises(ValueError, match=match):
            load_megatron_checkpoint(bad, _pcfg(jcfg))


def test_merge_strategies_are_the_jax_packages():
    from deepspeed_tpu.module_inject.megatron import megatron_merge_strategies as jax_ms
    for version in (0, 1.0, 2.0):
        assert megatron_merge_strategies(version) == jax_ms(version)
