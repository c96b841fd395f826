"""The autotuner (``deepspeed_tpu_torch/autotuning/``) against the JAX
package's, mirroring ``tests/unit/test_autotuning.py``.

- Prune: the estimate grows with the micro-batch, ZeRO divides the state
  only over a mesh (one card: a factor of 1), it counts the JAX state
  terms plus the params the tuner holds on the device and the backward's
  compute-dtype grads, an oversized candidate is pruned against a budget; the budget is the configured bytes, else the
  card's memory (16 GiB on the CPU, the JAX fallback).
- Given the same stubbed prune and metrics, the port's tuner measures the
  candidates the JAX tuner measures, in the same order, and writes the
  same optimal config (gridsearch, random, model-based; early stopping);
  the model-based search finds the grid's winner in fewer trials and
  steers by prediction; the JAX package's scan / flash-block axes, which
  nothing in the port reads, are refused by name.
- A CUDA error other than out of memory stops the search; out of memory
  skips the candidate.
- One real-engine measure of a tiny model on the CPU, its engine released;
  the optimal config trains through ``initialize``; ``cli autotune``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.autotuning import Autotuner as JaxAutotuner
from deepspeed_tpu.autotuning import AutotuningConfig as JaxAutotuningConfig
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxTConfig
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.autotuning import Autotuner, AutotuningConfig, apply_optimal
from deepspeed_tpu_torch.autotuning.autotuner import Candidate, activation_bytes
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.utils.pytree import tree_leaves as jax_tree_leaves

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq=32)
BASE = {"train_micro_batch_size_per_gpu": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "bf16": {"enabled": True}, "steps_per_print": 0}


def tiny_model():
    return CausalLM(TransformerConfig(**TINY))


def _pair(tmp_path, base=BASE, **cfg):
    """The port's and the JAX package's tuners on the same model and config."""
    cfg = {"results_dir": str(tmp_path / "port"), **cfg}
    port = Autotuner(tiny_model(), base_config=base, seq_len=32,
                     autotuning_config=AutotuningConfig(**cfg), device="cpu")
    jcfg = {**cfg, "results_dir": str(tmp_path / "jax")}
    jax_at = JaxAutotuner(JaxCausalLM(JaxTConfig(**TINY)), base_config=base, seq_len=32,
                          autotuning_config=JaxAutotuningConfig(**jcfg))
    return port, jax_at


def _stub(monkeypatch, at, metric, log):
    monkeypatch.setattr(at, "prune", lambda c: (True, 0))

    def measure(cand):
        log.append(cand.name())
        return metric(cand)
    monkeypatch.setattr(at, "measure", measure)


class TestPrune:

    def test_estimate_scales_with_micro_batch(self):
        at = Autotuner(tiny_model(), base_config={}, seq_len=32, device="cpu")
        small = at.estimate_bytes(Candidate(1, 1, "none", 0))
        big = at.estimate_bytes(Candidate(1, 64, "none", 0))
        assert big > small

    def test_budget_prunes_oversized(self):
        at = Autotuner(tiny_model(), base_config={}, seq_len=32, device="cpu",
                       autotuning_config=AutotuningConfig(hbm_budget_bytes=1, hbm_fraction=1.0))
        fits, _ = at.prune(Candidate(1, 1, "none", 0))
        assert not fits

    def test_zero_stage_divides_state_only_over_a_mesh(self):
        one = Autotuner(tiny_model(), base_config={}, seq_len=32, device="cpu")
        assert {one._shard_factor(s, w) for s in (0, 1, 2, 3)
                for w in ("master_opt", "grads", "params")} == {1}
        assert one.estimate_bytes(Candidate(3, 1, "none", 0)) == \
            one.estimate_bytes(Candidate(1, 1, "none", 0))
        mesh = Autotuner(tiny_model(), base_config={"mesh": {"dp": 8}}, seq_len=32, device="cpu")
        assert mesh.estimate_bytes(Candidate(3, 1, "none", 0)) < \
            mesh.estimate_bytes(Candidate(1, 1, "none", 0))

    def test_estimate_counts_the_held_params_and_the_backward_grads(self):
        cand = Candidate(0, 2, "none", 0)
        for base, cb in (({}, 4), (BASE, 2)):
            at = Autotuner(tiny_model(), base_config=base, seq_len=32, device="cpu")
            leaves = [t for t in jax_tree_leaves(at.params)]
            P = sum(t.numel() for t in leaves)
            held = sum(t.numel() * t.element_size() for t in leaves)
            jax_state = (2 + 4 + 8 + 4) * P
            act = activation_bytes(at._variant(cand), cand, 32, cb)
            assert at.estimate_bytes(cand) == held + jax_state + cb * P + act
        host = Autotuner(tiny_model(), model_parameters=at.params, base_config=BASE, seq_len=32,
                         device="meta")
        # the caller's params lie off the trials' device: they take none of its memory
        assert host.estimate_bytes(cand) == jax_state + 2 * P + act

    def test_budget_reads_the_config_else_the_device(self):
        cfg = AutotuningConfig(hbm_budget_bytes=1000, hbm_fraction=0.5)
        assert Autotuner(tiny_model(), seq_len=32, device="cpu",
                         autotuning_config=cfg).hbm_budget() == 500
        at = Autotuner(tiny_model(), seq_len=32, device="cpu")
        assert at.hbm_budget() == int(16 * 1024**3 * 0.9)

    def test_activations_follow_the_remat_policy(self):
        # 16 layers: the one layer a remat policy recomputes at a time is
        # small beside what "none" keeps of every layer
        model = CausalLM(TransformerConfig(**{**TINY, "n_layer": 16}))
        b = {r: activation_bytes(model, Candidate(0, 4, r, 0), 32, 2)
             for r in ("none", "full", "selective", "dots", "offload_dots")}
        assert b["none"] > b["dots"] > b["selective"] > b["full"] == b["offload_dots"] > 0
        plain = dataclasses.replace(model.config, fused_cross_entropy="off")
        assert activation_bytes(CausalLM(plain), Candidate(0, 4, "full", 0), 32, 2) > b["full"]
        assert activation_bytes(lambda p, b: 0, Candidate(0, 4, "full", 0), 32, 2) == 0


def _fake(cand):
    # throughput grows with mbs, 'dots' beats 'none', chunking helps: smooth
    # in the cost model's ordinal features
    return (cand.micro_batch * 100 + (50 if cand.remat == "dots" else 0)
            + (5 if cand.loss_chunk else 0))


@pytest.mark.parametrize("tuner", ["gridsearch", "random", "model_based"])
def test_same_trials_and_optimal_config_as_jax(tuner, tmp_path, monkeypatch):
    port, jax_at = _pair(tmp_path, fast=False, zero_stages=[0, 1], remat_policies=["none", "dots"],
                         loss_chunks=[0, 2048], min_train_micro_batch_size_per_gpu=1,
                         max_train_micro_batch_size_per_gpu=8, tuner_type=tuner,
                         tuner_num_trials=10, tuner_early_stopping=3)
    got, want = [], []
    _stub(monkeypatch, port, _fake, got)
    _stub(monkeypatch, jax_at, _fake, want)
    best, jbest = port.tune(), jax_at.tune()
    assert got == want and len(got) > 1
    assert best == jbest
    for d in ("port", "jax"):
        opt = json.loads((tmp_path / d / "ds_config_optimal.json").read_text())
        assert opt == best
    rows = json.loads((tmp_path / "port" / "autotuning_results.json").read_text())["records"]
    jrows = json.loads((tmp_path / "jax" / "autotuning_results.json").read_text())["records"]
    # the JAX records also carry the scan / block axes, at their defaults
    assert all((r["candidate"]["scan_layers"], r["candidate"]["attn_block"]) == (None, 0)
               for r in jrows)
    assert [(r["candidate"], r["pruned"], r["metric"]) for r in rows] == \
        [({k: r["candidate"][k] for k in rows[0]["candidate"]}, r["pruned"], r["metric"])
         for r in jrows]


def test_early_stopping(tmp_path, monkeypatch):
    cfg = AutotuningConfig(fast=True, zero_stages=[1], min_train_micro_batch_size_per_gpu=1,
                           max_train_micro_batch_size_per_gpu=64, tuner_early_stopping=2,
                           results_dir=str(tmp_path))
    at = Autotuner(tiny_model(), base_config={}, seq_len=32, autotuning_config=cfg, device="cpu")
    measured = []
    _stub(monkeypatch, at, lambda c: 1000.0 / c.micro_batch, measured)
    best = at.tune()
    assert best["train_micro_batch_size_per_gpu"] == 1
    assert len(measured) == 3       # best + 2 stale = early stop


class TestModelBasedTuner:

    def _base(self, tmp_path, **over):
        cfg = AutotuningConfig(
            fast=False, zero_stages=[1], remat_policies=["none", "dots"],
            loss_chunks=[0, 2048], min_train_micro_batch_size_per_gpu=1,
            max_train_micro_batch_size_per_gpu=8, results_dir=str(tmp_path), tuner_num_trials=50, **over)
        return Autotuner(tiny_model(), base_config=BASE, seq_len=32, autotuning_config=cfg,
                         device="cpu")

    def test_same_winner_fewer_trials_than_grid(self, tmp_path, monkeypatch):
        grid_measured, mb_measured = [], []
        at_grid = self._base(tmp_path / "grid")
        _stub(monkeypatch, at_grid, _fake, grid_measured)
        best_grid = at_grid.tune()
        at_mb = self._base(tmp_path / "mb", tuner_type="model_based", tuner_early_stopping=2)
        _stub(monkeypatch, at_mb, _fake, mb_measured)
        best_mb = at_mb.tune()
        assert best_mb["train_micro_batch_size_per_gpu"] == \
            best_grid["train_micro_batch_size_per_gpu"] == 8
        assert best_mb["model_overrides"] == best_grid["model_overrides"]
        assert len(mb_measured) < len(grid_measured), (mb_measured, grid_measured)

    def test_prediction_steers_measure_order(self, tmp_path, monkeypatch):
        measured = []
        at = self._base(tmp_path, tuner_type="model_based", tuner_num_seed_trials=3,
                        tuner_early_stopping=3)
        _stub(monkeypatch, at, _fake, measured)
        at.tune()
        assert "mbs8" in measured[3] or "mbs4" in measured[3], measured


@pytest.mark.parametrize("axis", [{"scan_layers_options": [True, False]},
                                  {"attn_blocks": [0, 512]}])
def test_scan_and_block_axes_are_refused(axis):
    """The JAX tuner searches them (its config takes them); nothing in the
    port reads ``scan_layers`` or ``attn_block_q`` / ``attn_block_k``, so a
    search would time identical trials: the config refuses them by name."""
    (name, value), = axis.items()
    assert getattr(JaxAutotuningConfig(**axis), name) == value
    with pytest.raises(NotImplementedError, match=f"autotuning.{name}.*scan and block axes"):
        AutotuningConfig(**axis)
    assert getattr(AutotuningConfig(**{name: getattr(AutotuningConfig(), name)}), name) \
        in ([None], [0])


@pytest.mark.parametrize("error, skipped", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("flash_attention launch failed: CUDA error 700"), False),
    (RuntimeError("nvcc failed:\nptxas error"), False),
    (ValueError("train_batch_size is not divisible"), True)])
def test_a_device_fault_stops_the_search_out_of_memory_skips(error, skipped, tmp_path,
                                                             monkeypatch):
    cfg = AutotuningConfig(zero_stages=[0], min_train_micro_batch_size_per_gpu=1,
                           max_train_micro_batch_size_per_gpu=2, results_dir=str(tmp_path))
    at = Autotuner(tiny_model(), base_config=BASE, seq_len=32, autotuning_config=cfg,
                   device="cpu")
    monkeypatch.setattr(at, "prune", lambda c: (True, 0))

    def measure(cand):
        if cand.micro_batch == 2:
            raise error
        return 1.0
    monkeypatch.setattr(at, "measure", measure)
    if skipped:
        assert at.tune()["train_micro_batch_size_per_gpu"] == 1
        assert [r.pruned for r in at.records] == [False, True]
    else:
        with pytest.raises(type(error), match=str(error).split(":")[0]):
            at.tune()


def test_measure_real_engine_and_train_the_optimal_config(tmp_path):
    """One real engine measurement on the CPU (the trial's engine released
    before it returns), then the optimal config, its model overrides
    applied, trains a step through ``initialize``."""
    cfg = AutotuningConfig(start_profile_step=1, end_profile_step=2, results_dir=str(tmp_path),
                           zero_stages=[0], min_train_micro_batch_size_per_gpu=2,
                           max_train_micro_batch_size_per_gpu=2)
    base = {**BASE, "train_micro_batch_size_per_gpu": 2}
    at = Autotuner(tiny_model(), base_config=base, seq_len=32, autotuning_config=cfg,
                   device="cpu")
    val = at.measure(Candidate(stage=0, micro_batch=2, remat="dots", loss_chunk=0))
    assert val > 0 and at.last_peak_bytes is None
    best = at.tune()
    assert best["model_overrides"] == {"remat": "none", "loss_chunk": 0}
    model, config = apply_optimal(tiny_model(), best)
    assert model.config.remat is False and "model_overrides" not in config
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    ids = np.random.default_rng(0).integers(0, 128, (2, 32))
    assert np.isfinite(float(engine.train_batch({"input_ids": ids})))


def test_config_bounds_like_jax():
    for bad in ({"metric": "speed"}, {"tuner_type": "bayes"}, {"tuner_num_trials": 0},
                {"hbm_fraction": 1.5}, {"start_profile_step": -1}):
        with pytest.raises(ValueError):
            AutotuningConfig(**bad)
        with pytest.raises(ValueError):
            JaxAutotuningConfig(**bad)
    got, want = AutotuningConfig(), JaxAutotuningConfig()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_cli_autotune(tmp_path, capsys, monkeypatch):
    from deepspeed_tpu_torch.models import presets
    monkeypatch.setitem(presets.MODEL_PRESETS, "tiny_test",
                        lambda **over: CausalLM(TransformerConfig(**{**TINY, **over})))
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps({**BASE, "bf16": {"enabled": False}, "autotuning": {
        "enabled": True, "zero_stages": [0], "min_train_micro_batch_size_per_gpu": 1,
        "max_train_micro_batch_size_per_gpu": 1, "start_profile_step": 1,
        "end_profile_step": 2, "results_dir": str(tmp_path / "res")}}))
    assert cli.main(["autotune", str(path), "--model", "tiny_test", "--seq-len", "16",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    best = json.loads(out[out.index("{"):])
    assert best["train_micro_batch_size_per_gpu"] == 1
    assert best == json.loads((tmp_path / "res" / "ds_config_optimal.json").read_text())
