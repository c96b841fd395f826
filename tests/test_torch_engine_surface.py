"""The engine surface the port adds in this slice, each method held to the
JAX engine on a one-device mesh (the tiny Llama of ``test_torch_training.py``,
fp32 unless a case says otherwise): the config accessors (``get_mom``,
``optimizer_name``, ``scheduler_name`` / ``_params``,
``zero_optimization`` / ``_stage``, ``zero_enabled``,
``dynamic_loss_scale``, ``get_batch_info``), ``set_train_batch_size``,
``micro_steps``, ``zero_grad``, ``train`` / ``eval``,
``module_state_dict`` / ``load_module_state_dict``, ``set_batch_fn``,
``save_16bit_model``, ``destroy``; and the package's top-level exports."""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import TransformerConfig
from tests.test_torch_training import (LEAF_TOL, LLAMA, LOSS_TOL, _batches, _config,
                                       _jax_params, _leaf_errs, _port,
                                       one_device_mesh)  # noqa: F401

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

ACCESSORS = ("get_mom", "optimizer_name", "scheduler_name", "scheduler_params",
             "zero_optimization", "zero_optimization_stage", "zero_enabled",
             "dynamic_loss_scale", "get_batch_info", "fp16_enabled", "bfloat16_enabled",
             "gradient_accumulation_steps", "train_batch_size")
CONFIGS = {
    "fusedadam": _config(),
    "fp16_dynamic": _config(fp16={"enabled": True}, zero_optimization={"stage": 2}),
    "fp16_static": _config(fp16={"enabled": True, "loss_scale": 128.0}),
    "bf16_sgd": _config(bf16={"enabled": True}, scheduler=None,
                        optimizer={"type": "SGD", "params": {"lr": 1e-3, "momentum": 0.8}}),
    "lion_stage3": _config(optimizer={"type": "Lion", "params": {"lr": 1e-4,
                                                                 "betas": [0.8, 0.9]}},
                           zero_optimization={"stage": 3}),
    "adamw_default": _config(optimizer={"type": "AdamW", "params": {"lr": 1e-3}}),
}


def _pair(mesh, config, seed=3):
    jmodel, jparams = _jax_params(LLAMA, seed=seed)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=mesh)
    return jeng, _port(LLAMA, jparams, config)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_accessors_match_the_jax_engine(one_device_mesh, name):
    config = {k: v for k, v in CONFIGS[name].items() if v is not None}
    jeng, peng = _pair(one_device_mesh, config)
    for attr in ACCESSORS:
        want, got = getattr(jeng, attr)(), getattr(peng, attr)()
        assert got == want, (attr, got, want)


def test_set_train_batch_size_matches_the_jax_engine(one_device_mesh):
    """gas 1 -> 2 in both: accumulation moves to fp32 buffers and the next
    steps agree; an indivisible batch raises in both."""
    config = _config(gas=1)
    jeng, peng = _pair(one_device_mesh, config)
    assert peng.state.acc_grads is None
    for eng in (jeng, peng):
        eng.set_train_batch_size(4)
        with pytest.raises(ValueError, match="divisible"):
            eng.set_train_batch_size(5)
    assert peng.get_batch_info() == jeng.get_batch_info() == (4, 2, 2)
    assert {g.dtype for g in peng.state.acc_grads.values()} == {torch.float32}
    for batch in _batches(31, 2, 4):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want)
    assert peng.micro_steps == int(jeng.micro_steps) == 4
    assert peng.global_steps == int(jeng.global_steps) == 2


def test_trio_with_zero_grad_matches_the_jax_engine(one_device_mesh):
    """A micro-step's gradients dropped by zero_grad (its count stays) leave
    no trace in either engine: the boundary step after the next micro-step
    updates from that one's gradients alone, in both alike."""
    jeng, peng = _pair(one_device_mesh, _config())
    stray, b1 = _batches(32, 2, 2)
    for eng in (jeng, peng):
        eng.forward(stray)
        eng.backward()
        eng.zero_grad()
    assert all(float(g.abs().max()) == 0.0 for g in peng.state.acc_grads.values())
    for eng in (jeng, peng):
        eng.forward(b1)
        eng.backward()
        eng.step()
    assert peng.micro_steps == int(jeng.micro_steps) == 2
    assert peng.global_steps == int(jeng.global_steps) == 1
    assert max(jax.tree.leaves(_leaf_errs(peng.module.config, peng, jeng.state.params))) \
        <= LEAF_TOL


def test_train_and_eval_record_the_mode(one_device_mesh):
    jeng, peng = _pair(one_device_mesh, _config())
    for eng in (jeng, peng):
        assert eng.eval() is eng and eng._training_mode is False
        assert eng.train() is eng and eng._training_mode is True


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_module_state_dict_round_trip_matches_the_jax_engine(one_device_mesh, dtype):
    """load_module_state_dict of another model's weights: params in the
    compute dtype, the masters following, in both engines; strict=False
    overlays the embedding alone; a wrong structure raises in both."""
    config = _config(**({"bf16": {"enabled": True}} if dtype == "bf16" else {}))
    jeng, peng = _pair(one_device_mesh, config)
    cfg = TransformerConfig(**LLAMA)
    _, other = _jax_params(LLAMA, seed=13)
    jeng.load_module_state_dict(jax.tree.map(np.asarray, other))
    peng.load_module_state_dict(params_from_jax(cfg, other))
    assert max(jax.tree.leaves(_leaf_errs(cfg, peng, jeng.state.params))) == 0.0
    if dtype == "bf16":
        for n, m in peng.state.master.items():
            assert m.dtype == torch.float32
            assert torch.equal(m, dict(peng.state.params.named_parameters())[n].float())
    got = peng.module_state_dict()
    assert torch.equal(got["embed"]["tokens"], peng.state.params["embed"]["tokens"])

    _, third = _jax_params(LLAMA, seed=14)
    jeng.load_module_state_dict({"embed": {"tokens": np.asarray(third["embed"]["tokens"])}},
                                strict=False)
    peng.load_module_state_dict({"embed": {"tokens": torch.tensor(
        np.asarray(third["embed"]["tokens"]))}}, strict=False)
    assert max(jax.tree.leaves(_leaf_errs(cfg, peng, jeng.state.params))) == 0.0
    with pytest.raises(ValueError, match="structure"):
        jeng.load_module_state_dict({"embed": {"tokens": np.zeros(3)}})
    with pytest.raises(ValueError, match="structure"):
        peng.load_module_state_dict({"embed": {"tokens": torch.zeros(3)}})


def test_set_batch_fn_runs_before_the_step_in_both(one_device_mesh):
    jeng, peng = _pair(one_device_mesh, _config())

    def shift(batch):
        return {"input_ids": (np.asarray(batch["input_ids"]) + 1) % LLAMA["vocab_size"]}

    for eng in (jeng, peng):
        eng.set_batch_fn(shift)
    batch = _batches(33, 1, 4)[0]
    want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    plain = _port(LLAMA, _jax_params(LLAMA, seed=3)[1], _config())
    assert float(plain.train_batch(batch)) != got


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_save_16bit_model_writes_the_jax_file(one_device_mesh, dtype, tmp_path):
    config = _config(**({"bf16": {"enabled": True}} if dtype == "bf16" else {}))
    jeng, peng = _pair(one_device_mesh, config)
    jpath = jeng.save_16bit_model(str(tmp_path / "jax"))
    ppath = peng.save_fp16_model(str(tmp_path / "port"))
    assert os.path.basename(ppath) == os.path.basename(jpath) == "model_16bit.npz"
    with np.load(jpath) as jz, np.load(ppath) as pz:
        assert sorted(pz.files) == sorted(jz.files)
        assert "layers.attn.wq::bf16" in pz.files
        for k in jz.files:
            assert pz[k].dtype == jz[k].dtype and pz[k].shape == jz[k].shape
            np.testing.assert_array_equal(pz[k], jz[k])


def test_destroy_stops_the_writer_and_drops_the_state(one_device_mesh, tmp_path):
    jeng, peng = _pair(one_device_mesh, _config())
    for eng in (jeng, peng):
        eng.save_checkpoint(str(tmp_path / type(eng).__module__), asynchronous=True)
        eng.flush_checkpoints()
        writer = eng._ckpt_writer
        eng.destroy()
        assert eng.state is None and eng._ckpt_writer is None
        assert writer._stopped


def test_initialize_returns_the_engines_dataloader():
    model = deepspeed_tpu_torch.models.llama("tiny", n_layer=1, d_model=64, n_head=1,
                                             d_ff=64, vocab_size=32, max_seq=16)
    data = [{"input_ids": np.arange(16, dtype=np.int32) % 32} for _ in range(6)]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 4, "dataloader_drop_last": True},
        training_data=data, collate_fn=lambda s: {"input_ids": np.stack(
            [x["input_ids"] for x in s])}, device="cpu")
    assert loader is engine.training_dataloader
    assert loader.batch_size == 4 and loader.drop_last and len(loader) == 1
    assert np.isfinite(float(engine.train_batch()))
    assert engine._data_progress == {"consumed_samples": 4, "iterations": 1}
    with pytest.raises(ValueError, match="needs a batch"):
        deepspeed_tpu_torch.initialize(model=model, config={"train_batch_size": 4},
                                       device="cpu")[0].train_batch()


EXPORTS = ("DeepSpeedEngine", "InferenceEngine", "DeepSpeedConfig", "DeepSpeedConfigError",
           "DeepSpeedInferenceConfig", "DeepSpeedTransformerLayer", "log_dist",
           "add_config_arguments", "add_tuning_arguments")


def test_top_level_exports():
    assert deepspeed_tpu_torch.__version__ == deepspeed_tpu.__version__
    for name in EXPORTS:
        assert getattr(deepspeed_tpu_torch, name).__name__ == \
            getattr(deepspeed_tpu, name).__name__, name
        assert name in dir(deepspeed_tpu_torch)
    assert deepspeed_tpu_torch.DeepSpeedEngine.__module__.startswith("deepspeed_tpu_torch.")
    with pytest.raises(AttributeError):
        deepspeed_tpu_torch.no_such_export
    argv = ["--deepspeed", "--deepspeed_config", "ds.json", "--warmup_num_steps", "7",
            "--lr_range_test_staircase", "false"]

    def parse(mod):
        parser = mod.add_tuning_arguments(mod.add_config_arguments(argparse.ArgumentParser()))
        return vars(parser.parse_args(argv))

    assert parse(deepspeed_tpu_torch) == parse(deepspeed_tpu)
