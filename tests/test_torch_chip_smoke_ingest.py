"""Phase ``ingest`` of ``chip_smoke.py`` on the CPU: the HF and Megatron
writers read back by the JAX loaders and the port's, the planted faults,
and the phase at tiny widths. Apart from ``test_torch_chip_smoke.py`` so
the test runner can place it on another worker."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


# ---- phase ingest: the HF and Megatron writers, its faults, the phase ----

INGEST_TINY = {
    "llama": {"model_type": "llama", "vocab_size": 256, "hidden_size": 128,
              "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
              "num_key_value_heads": 2, "max_position_embeddings": 1024, "rms_norm_eps": 1e-05,
              "tie_word_embeddings": False},
    "gpt2": {"model_type": "gpt2", "vocab_size": 256, "n_positions": 256, "n_embd": 128,
             "n_layer": 12, "n_head": 2},
    "bloom": {"model_type": "bloom", "vocab_size": 256, "hidden_size": 128, "n_layer": 24,
              "n_head": 2},
    "gpt_neox": {"model_type": "gpt_neox", "vocab_size": 256, "hidden_size": 192,
                 "num_hidden_layers": 44, "num_attention_heads": 2, "intermediate_size": 256,
                 "max_position_embeddings": 256, "rotary_pct": 0.25,
                 "use_parallel_residual": True, "tie_word_embeddings": False},
}


def _tiny_checkpoint(d, model_type, layers=2, seed=0, shard_bytes=None):
    """A tiny model of ``model_type`` written by the phase's HF writer in
    bf16; returns (config, the params written)."""
    from deepspeed_tpu_torch.module_inject import policy_for
    hf = {**INGEST_TINY[model_type], chip_smoke._LAYER_KEY[model_type]: layers}
    cfg = policy_for(model_type).zoo_config(hf)
    params = CausalLM(cfg).init_params(torch.Generator().manual_seed(seed),
                                       dtype=torch.bfloat16)
    chip_smoke.write_hf_checkpoint(str(d), hf, chip_smoke.hf_entries(
        model_type, cfg, params, torch.bfloat16), shard_bytes=shard_bytes)
    return cfg, params


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    """Each family's tiny checkpoint, sharded, written once for the module:
    model type -> (directory, config, the params written). The tests only
    read them (the missing-shard faults restore what they move)."""
    out = {}
    for model_type in sorted(INGEST_TINY):
        d = tmp_path_factory.mktemp(model_type)
        out[model_type] = (d, *_tiny_checkpoint(d, model_type, shard_bytes=200_000))
    return out


@pytest.mark.parametrize("model_type", sorted(INGEST_TINY))
def test_hf_writer_is_read_back_by_the_jax_loader(model_type, tiny_ckpts):
    """The writer is the inverse of each policy's map_params: the JAX
    package's loader (the safetensors library's reader) reads its shards
    and index to the tree written, and so does the port's loader, bit for
    bit."""
    import jax
    from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
    d, cfg, params = tiny_ckpts[model_type]
    with open(d / "model.safetensors.index.json") as f:
        assert len(set(json.load(f)["weight_map"].values())) > 1     # sharded
    _, jtree = jax_load(str(d))
    want = params_to_jax(cfg, params.map(lambda t: t.float()))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jtree, want)
    _, tree = load_hf_checkpoint(str(d), dtype=torch.bfloat16)
    assert not chip_smoke._equal_leaves(tree, params)


def test_safetensors_writer_matches_the_library(tmp_path):
    from safetensors.numpy import load_file
    t = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
         "b": torch.ones(3, dtype=torch.float32)}
    entries = [(k, tuple(v.shape), v.dtype, lambda v=v: v) for k, v in t.items()]
    n = chip_smoke.write_safetensors(str(tmp_path / "x.safetensors"), entries)
    assert n == (tmp_path / "x.safetensors").stat().st_size
    got = load_file(str(tmp_path / "x.safetensors"))
    np.testing.assert_array_equal(got["b"], t["b"].numpy())
    np.testing.assert_array_equal(got["a"].view(np.int16), t["a"].view(torch.int16).numpy())


def test_untransposed_qk_is_planted_through_the_loader(tiny_ckpts):
    from deepspeed_tpu_torch.module_inject import POLICIES, load_hf_checkpoint
    d, _, params = tiny_ckpts["llama"]
    real = POLICIES["llama"]
    with chip_smoke.untransposed_qk():
        _, faulted = load_hf_checkpoint(str(d), dtype=torch.bfloat16)
    assert POLICIES["llama"] is real
    bad = chip_smoke._equal_leaves(faulted, params)
    assert sorted(bad) == ["layers.0.attn.wk", "layers.0.attn.wq", "layers.1.attn.wk",
                           "layers.1.attn.wq"]
    assert torch.equal(faulted["layers"][0]["attn"]["wq"], params["layers"][0]["attn"]["wq"].t())


def test_missing_shard_faults_raise_and_leave_the_checkpoint(tiny_ckpts):
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
    d, _, params = tiny_ckpts["llama"]
    before = sorted(os.listdir(d))
    raised = chip_smoke.missing_shard_faults(str(d), load_hf_checkpoint)
    assert raised["shard_dropped_from_index"].startswith("KeyError")
    assert raised["shard_missing_on_disk"].startswith("FileNotFoundError")
    assert sorted(os.listdir(d)) == before
    _, tree = load_hf_checkpoint(str(d), dtype=torch.bfloat16)
    assert not chip_smoke._equal_leaves(tree, params)


def test_megatron_writer_is_read_back_by_the_jax_loader(tmp_path):
    import dataclasses
    import jax
    from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
    from deepspeed_tpu.module_inject.megatron import load_megatron_checkpoint
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    cfg = TransformerConfig(vocab_size=64, max_seq=32, n_layer=2, n_head=4, d_model=32,
                            d_ff=64, pos_embedding="learned", attn_bias=True)
    params = CausalLM(cfg).init_params(torch.Generator().manual_seed(0))
    meta = chip_smoke.write_megatron_checkpoint(str(tmp_path), params, tp=2)
    jtree = load_megatron_checkpoint(meta, JaxConfig(**dataclasses.asdict(cfg)))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jtree,
                 params_to_jax(cfg, params))


def test_ingest_phase_runs_its_checks_on_the_cpu(monkeypatch, tmp_path, capsys):
    """phase_ingest at tiny widths on the CPU (bf16 plain versions against
    fp32 ones; no kernels, so no launch rule): the leaves bit-equal, every
    served row equal to the in-memory engine's, the planted faults shown,
    the three families and the Megatron json through, the checkpoints
    deleted."""
    class Accelerator:
        def reset_peak_memory_stats(self):
            pass

        def max_memory_allocated(self):
            return 0

    import deepspeed_tpu_torch.accelerator as accel
    monkeypatch.setattr(chip_smoke, "INGEST_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "INGEST_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(chip_smoke, "SHARD_BYTES", 400_000)
    monkeypatch.setattr(chip_smoke, "LLAMA2_7B_HF", INGEST_TINY["llama"])
    monkeypatch.setattr(chip_smoke, "INGEST_FAMILIES", {
        "gpt2-tiny": INGEST_TINY["gpt2"], "bloom-tiny": INGEST_TINY["bloom"],
        "gpt-neox-tiny": INGEST_TINY["gpt_neox"]})
    monkeypatch.setattr(chip_smoke, "serve_launch_rule", lambda cfg, actions: {
        "flash_attention_fwd": 0, "paged_decode_attention": 0})
    monkeypatch.setattr(chip_smoke, "prefill_launch_rule", lambda cfg, n: 0)
    real_megatron = chip_smoke._megatron_serve
    monkeypatch.setattr(chip_smoke, "_megatron_serve", lambda seed: real_megatron(
        seed, model=CausalLM(TransformerConfig(vocab_size=256, max_seq=256, n_layer=2,
                                               n_head=2, d_model=128, attn_bias=True))))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(accel, "get_accelerator", lambda *a: Accelerator())
    chip_smoke.phase_ingest({}, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "ingest" and line["leaves_equal"] and line["shards"] > 1
    assert line["rows_equal_in_memory"] == line["requests"] == 12
    fault = line["fault_untransposed_qk"]
    assert fault["rows_differ"] > 0 or fault["ulp_err"] > chip_smoke.LOGIT_ULP_TOL
    assert all(line["fault_missing_shard"].values())
    assert sorted(line["families"]) == ["bloom-tiny", "gpt-neox-tiny", "gpt2-tiny"]
    assert line["families"]["gpt-neox-tiny"]["head_dim"] == 96
    assert all(f["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL for f in line["families"].values())
    assert line["megatron"]["rows_equal"] == 2
    assert not (tmp_path / "ckpt").exists()
