"""The offline checkpoint tools in the port (``checkpoint/zero_to_fp32.py``,
``universal_checkpoint.py``, ``reshape_utils.py``, ``state_dict_factory.py``,
``reshape_pipeline.py``; ``safe_engine.read_state_tree``) against the JAX
package's, on tags written by both engines.

A tag the port's engine saved and one the JAX engine saved after the same
step (tiny Llama, AdamW; the port in fp32 and in bf16): ``zero_to_fp32`` of
either package on either tag gives the same arrays; ``ds_to_universal`` of
one package loads through the other's ``load_universal_into_params`` to the
same weights, both ways, and the two packages write the same universal
files. The reshape helpers, the SD loader and the stage-tree functions are
the JAX package's cases on numpy and torch inputs. Refusals:
``reshape_pipeline_checkpoint`` (runtime/pipe/), a legacy orbax tag."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.checkpoint as jck
import deepspeed_tpu_torch
import deepspeed_tpu_torch.checkpoint as pck
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.checkpoint.state_dict_factory import MegatronSDLoader, SDLoaderFactory
from deepspeed_tpu_torch.config.core import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import read_state_tree
from tests.test_torch_training import (LLAMA, _batches, _config, _jax_params, _port,
                                       one_device_mesh)  # noqa: F401

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

ADAMW = {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.01}}


@pytest.fixture(scope="module")
def tags(one_device_mesh, tmp_path_factory):
    """{"jax", "port", "port_bf16"}: a checkpoint dir with one tag "step1",
    each engine after the same step from the same weights."""
    root = tmp_path_factory.mktemp("tags")
    jmodel, jparams = _jax_params(LLAMA, seed=5)
    batch = _batches(31, 1, 4)[0]
    out = {}
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=_config(optimizer=ADAMW),
                                             mesh=one_device_mesh)
    jeng.train_batch(batch)
    jeng.save_checkpoint(str(root / "jax"), tag="step1")
    out["jax"] = str(root / "jax")
    for name, over in (("port", {}), ("port_bf16", {"bf16": {"enabled": True}})):
        peng = _port(LLAMA, jparams, _config(optimizer=ADAMW, **over))
        peng.train_batch(batch)
        peng.save_checkpoint(str(root / name), tag="step1")
        out[name] = str(root / name)
    return out


def _same_arrays(got, want, exact=True):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if exact:
            assert np.array_equal(g, w), k
        else:
            assert np.abs(g - w).max() <= 3e-5 * np.abs(w).max(), k


@pytest.mark.parametrize("writer", ["jax", "port", "port_bf16"])
def test_zero_to_fp32_equals_the_jax_tool(tags, writer):
    d = tags[writer]
    got = pck.get_fp32_state_dict_from_zero_checkpoint(d, tag="step1")
    _same_arrays(got, jck.get_fp32_state_dict_from_zero_checkpoint(d, tag="step1"))
    # the masters, not the stored (bf16) params
    tree = read_state_tree(os.path.join(d, "step1"))
    if tree.get("master") is not None:
        np.testing.assert_array_equal(got["embed.tokens"], tree["master"]["embed"]["tokens"])
    assert got.keys() == pck.get_fp32_state_dict_from_zero_checkpoint(d).keys()  # via latest


def test_zero_to_fp32_of_the_two_engines_agrees(tags):
    """The same step in both engines: the consolidated weights agree within
    the training tests' leaf tolerance."""
    _same_arrays(pck.get_fp32_state_dict_from_zero_checkpoint(tags["port"]),
                 pck.get_fp32_state_dict_from_zero_checkpoint(tags["jax"]), exact=False)


def test_convert_writes_the_jax_tools_file(tags, tmp_path):
    pck.convert_zero_checkpoint_to_fp32_state_dict(tags["port"], str(tmp_path / "p.npz"))
    jck.convert_zero_checkpoint_to_fp32_state_dict(tags["port"], str(tmp_path / "j.npz"))
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        _same_arrays({k: p[k] for k in p.files}, {k: j[k] for k in j.files})


def test_zero_to_fp32_cli(tags, tmp_path, monkeypatch):
    import sys
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32
    out = str(tmp_path / "cli.npz")
    monkeypatch.setattr(sys, "argv", ["zero_to_fp32", tags["jax"], out, "--tag", "step1"])
    zero_to_fp32.main()
    with np.load(out) as z:
        assert "embed.tokens" in z.files


def test_offload_sidecar_masters_are_read_as_the_jax_tool_reads_them(tags, tmp_path):
    d = str(tmp_path / "ckpt")
    shutil.copytree(tags["port_bf16"], d)
    tree = read_state_tree(os.path.join(d, "step1"))
    shape = tuple(tree["params"]["ln_f"]["scale"].shape)
    side = np.arange(np.prod(shape), dtype=np.float32) / 7
    np.savez(os.path.join(d, "step1", "offload_state_p0.npz"), **{"masters|ln_f.scale": side})
    # the sidecar is read for a leaf without a master in the state tree
    tree_file = os.path.join(d, "step1", "state.npz")
    with np.load(tree_file) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("master.ln_f.")}
    np.savez(tree_file, **kept)
    got = pck.get_fp32_state_dict_from_zero_checkpoint(d, tag="step1")
    _same_arrays(got, jck.get_fp32_state_dict_from_zero_checkpoint(d, tag="step1"))
    np.testing.assert_array_equal(got["ln_f.scale"], side.reshape(shape))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_universal_files_are_the_jax_tools(tags, tmp_path, writer):
    pck.ds_to_universal(tags[writer], str(tmp_path / "p"), tag="step1")
    jck.ds_to_universal(tags[writer], str(tmp_path / "j"), tag="step1")
    got = pck.load_universal_state_dict(str(tmp_path / "p"))
    want = jck.load_universal_state_dict(str(tmp_path / "j"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]) == ["exp_avg", "exp_avg_sq", "param"], k
        _same_arrays(got[k], want[k])
    with open(tmp_path / "p" / "meta.json") as f, open(tmp_path / "j" / "meta.json") as g:
        assert json.load(f) == json.load(g)


def test_universal_moments_of_an_unlabelled_tag_are_the_jax_tools(tags, tmp_path):
    """A tag whose meta.json lacks opt_state_labels (written before the
    labels existed): both tools infer the moments from runs of param-shaped
    leaves, to the same files."""
    d = str(tmp_path / "ckpt")
    shutil.copytree(tags["port"], d)
    meta_path = os.path.join(d, "step1", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["opt_state_labels"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    pck.ds_to_universal(d, str(tmp_path / "p"))
    jck.ds_to_universal(d, str(tmp_path / "j"))
    got = pck.load_universal_state_dict(str(tmp_path / "p"))
    want = jck.load_universal_state_dict(str(tmp_path / "j"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]) == ["exp_avg", "exp_avg_sq", "param"], k
        _same_arrays(got[k], want[k])


def test_port_universal_loads_into_jax_params_and_back(tags, tmp_path):
    """A port tag's universal dir loads into a JAX tree (JAX loader), and a
    JAX tag's into a port tree (port loader): the same weights as the
    other package's loader gives."""
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    jmodel, jfresh = _jax_params(LLAMA, seed=9)
    pcfg = TransformerConfig(**LLAMA)
    pfresh = CausalLM(pcfg).init_params(torch.Generator().manual_seed(9))
    for writer, tool in (("port", pck), ("jax", jck)):
        uni = str(tmp_path / writer)
        tool.ds_to_universal(tags[writer], uni, tag="step1")
        jtree = jax.tree.map(np.asarray, jck.load_universal_into_params(uni, jfresh))
        ptree = pck.load_universal_into_params(uni, pfresh)
        want = dict(params_from_jax(pcfg, jtree).named_parameters())
        for name, t in ptree.named_parameters():
            assert t.dtype == torch.float32 and torch.equal(t, want[name]), (writer, name)
        fp32 = tool.get_fp32_state_dict_from_zero_checkpoint(tags[writer], tag="step1")
        back = params_to_jax(pcfg, ptree)
        np.testing.assert_array_equal(back["layers"]["attn"]["wq"], fp32["layers.attn.wq"])


def test_universal_into_params_keeps_each_leafs_dtype_and_raises_when_missing(tags, tmp_path):
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    uni = str(tmp_path / "u")
    pck.ds_to_universal(tags["port"], uni)
    model = CausalLM(TransformerConfig(**LLAMA))
    bf16 = model.init_params(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    got = pck.load_universal_into_params(uni, bf16)
    fp32 = pck.load_universal_into_params(uni, bf16, dtype=torch.float32)
    for (n, a), (_, b) in zip(got.named_parameters(), fp32.named_parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16)), n
    os.remove(os.path.join(uni, "params", "embed.tokens.npz"))
    with pytest.raises(KeyError):
        pck.load_universal_into_params(uni, bf16)
    os.remove(os.path.join(uni, "params", "layers.attn.wq.npz"))
    with pytest.raises(KeyError):
        pck.load_universal_into_params(uni, {"layers": bf16.to_dict()["layers"]})


def test_universal_reads_old_format_stages_entries(tmp_path):
    """An old-format universal dir with "stages.*" [S, L/S, ...] entries
    loads into the port's layers, as the JAX loader flattens them."""
    d = tmp_path / "uni" / "params"
    d.mkdir(parents=True)
    stacked = np.arange(4 * 3, dtype=np.float32).reshape(2, 2, 3)
    np.savez(d / "stages.ln_attn.scale.npz", param=stacked)
    np.savez(d / "ln_f.scale.npz", param=np.ones(3, np.float32))
    tree = {"layers": [{"ln_attn": {"scale": torch.zeros(3)}} for _ in range(4)],
            "ln_f": {"scale": torch.zeros(3)}}
    got = pck.load_universal_into_params(str(tmp_path / "uni"), tree)
    for i in range(4):
        np.testing.assert_array_equal(got["layers"][i]["ln_attn"]["scale"].numpy(),
                                      stacked.reshape(4, 3)[i])


def test_load_universal_is_parsed_as_the_jax_config_parses_it():
    from deepspeed_tpu.config.core import DeepSpeedConfig as JaxConfig
    for flag in (True, False):
        cfg = {"train_batch_size": 1, "checkpoint": {"load_universal": flag}}
        assert DeepSpeedConfig(cfg).load_universal_checkpoint is \
            JaxConfig(cfg, world_size=1).load_universal_checkpoint is flag
    engine = deepspeed_tpu_torch.initialize(
        model=_port_model(), config={"train_batch_size": 1,
                                     "checkpoint": {"load_universal": True}}, device="cpu")[0]
    assert engine._config.load_universal_checkpoint is True


def _port_model():
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    return CausalLM(TransformerConfig(**LLAMA))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_reshape_utils_are_the_jax_packages(kind):
    conv = (lambda a: a) if kind == "numpy" else torch.from_numpy
    back = (lambda a: a) if kind == "numpy" else (lambda t: t.numpy())
    full = np.arange(24.0).reshape(4, 6)
    shards = pck.split_tp_shards(conv(full), dim=1, tp_degree=3)
    want = jck.split_tp_shards(full, dim=1, tp_degree=3)
    assert all(np.array_equal(back(s), w) for s, w in zip(shards, want))
    np.testing.assert_array_equal(back(pck.merge_tp_shards(shards, dim=1)), full)
    fused = np.arange(48.0).reshape(2, 24)
    qkv = pck.split_qkv_shards(conv(fused), dim=1, tp_degree=2)
    jqkv = jck.split_qkv_shards(fused, dim=1, tp_degree=2)
    assert all(np.array_equal(back(s), w) for s, w in zip(qkv, jqkv))
    np.testing.assert_array_equal(back(pck.merge_qkv_shards(qkv, dim=1)), fused)
    assert type(pck.merge_qkv_shards([conv(fused)], dim=1)) is type(conv(fused))
    with pytest.raises(ValueError):
        pck.split_tp_shards(conv(np.zeros((4, 5))), dim=1, tp_degree=3)
    with pytest.raises(ValueError):
        pck.split_qkv_shards(conv(np.zeros((2, 9))), dim=1, tp_degree=2)
    assert pck.partition_data(list(range(6)), 3) == jck.partition_data(list(range(6)), 3)
    with pytest.raises(ValueError):
        pck.partition_data([1, 2, 3], 2)


def test_sd_loader_meta_json(tmp_path):
    meta = {"type": "BLOOM", "checkpoints": {"load": ["a.pt", "b.pt"]}, "version": 2.0,
            "base_dir": "/models/x"}
    p = tmp_path / "meta.json"
    p.write_text(json.dumps(meta))
    got = SDLoaderFactory.get_sd_loader_json(str(p))
    assert got == jck.SDLoaderFactory.get_sd_loader_json(str(p))
    assert got == ("BLOOM", ["/models/x/a.pt", "/models/x/b.pt"], 2.0)
    assert SDLoaderFactory.get_sd_loader_json({}) == ("Megatron", [], 1.0)


def test_sd_loader_merge_and_reslice(tmp_path):
    full_col = np.arange(32.0).reshape(4, 8).astype(np.float32)
    full_rep = np.ones((4,), np.float32)
    for rank in range(2):
        torch.save({"attn.qkv.weight": torch.tensor(np.split(full_col, 2, axis=1)[rank]),
                    "ln.weight": torch.tensor(full_rep)}, tmp_path / f"mp_rank_{rank:02d}.pt")
    loader = MegatronSDLoader([str(tmp_path / f"mp_rank_{r:02d}.pt") for r in range(2)])
    strategies = {"qkv": 1}
    merged = loader.load(merge_strategies=strategies)
    np.testing.assert_array_equal(merged["attn.qkv.weight"].numpy(), full_col)
    r1 = loader.load(mp_world_size=4, mp_rank=1, merge_strategies=strategies)
    np.testing.assert_array_equal(r1["attn.qkv.weight"].numpy(), np.split(full_col, 4, axis=1)[1])
    np.testing.assert_array_equal(r1["ln.weight"].numpy(), full_rep)


def test_sd_loader_fused_qkv_merge_strategy(tmp_path):
    full = np.arange(4 * 12, dtype=np.float32).reshape(4, 12)
    rank_shards = jck.split_qkv_shards(full, 1, 2)
    for rank, shard in enumerate(rank_shards):
        torch.save({"attn.query_key_value.weight": torch.tensor(shard)},
                   tmp_path / f"mp_rank_{rank:02d}.pt")
    paths = [str(tmp_path / f"mp_rank_{r:02d}.pt") for r in range(2)]
    loader, jloader = MegatronSDLoader(paths), jck.MegatronSDLoader(paths)
    for strat in ({"query_key_value": 1}, {"query_key_value": (1, "qkv")}):
        for kw in ({}, {"mp_world_size": 2, "mp_rank": 0}):
            got = loader.load(merge_strategies=strat, **kw)["attn.query_key_value.weight"]
            want = jloader.load(merge_strategies=strat, **kw)["attn.query_key_value.weight"]
            np.testing.assert_array_equal(got.numpy(), want)
    fused = loader.load(merge_strategies={"query_key_value": (1, "qkv")})
    np.testing.assert_array_equal(fused["attn.query_key_value.weight"].numpy(), full)


def _stage_tree(r):
    return {"attn": {"wq": r.normal(size=(2, 3, 4, 4)).astype(np.float32)},
            "ln": [r.normal(size=(2, 3, 4)).astype(np.float32)]}


def test_stage_tree_functions_are_the_jax_packages():
    tree = _stage_tree(np.random.default_rng(0))
    jflat = jck.stages_to_layers(tree)
    flat = pck.stages_to_layers(tree)
    assert jax.tree.structure(flat) == jax.tree.structure(jflat)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(flat), jax.tree.leaves(jflat)))
    for pp in (1, 2, 3, 6):
        got = pck.reshape_stages_tree(tree, pp)
        want = jck.reshape_stages_tree(tree, pp)
        assert all(np.array_equal(a, b)
                   for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
        back = pck.layers_to_stages(flat, pp)
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(back), jax.tree.leaves(jck.layers_to_stages(jflat, pp))))
    ttree = {"w": torch.arange(12.0).reshape(2, 3, 2)}
    assert pck.stages_to_layers(ttree)["w"].shape == (6, 2)
    with pytest.raises(ValueError, match="divisible"):
        pck.reshape_stages_tree(tree, 4)
    with pytest.raises(ValueError, match="divisible"):
        pck.layers_to_stages(flat, 4)


def test_reshape_pipeline_checkpoint_raises_naming_the_pipeline_item(tags, tmp_path):
    with pytest.raises(NotImplementedError, match="runtime/pipe/"):
        pck.reshape_pipeline_checkpoint(tags["port"], str(tmp_path / "x"), target_pp=2)


def test_read_state_tree_refuses_legacy_orbax_tags(tmp_path):
    (tmp_path / "t" / "state").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        read_state_tree(str(tmp_path / "t"))
    with pytest.raises(FileNotFoundError):
        read_state_tree(str(tmp_path / "none"))


def test_read_state_tree_decodes_bf16_leaves_to_torch(tags):
    tree = read_state_tree(os.path.join(tags["port_bf16"], "step1"))
    leaf = tree["params"]["embed"]["tokens"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    assert tree["master"]["embed"]["tokens"].dtype == np.float32
    assert "__torch_rng_state__" not in tree and "__rng_key_data__" not in tree
