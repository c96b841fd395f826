"""Phases ``client_opt`` and ``health`` of ``chip_smoke.py`` at a tiny size
on the CPU (bf16 compute params over fp32 masters, the kernels' plain
versions, host-clock events): every check each phase makes on the card,
and a planted engine fault the client_opt phase must catch. Apart from
``test_torch_chip_smoke.py`` so the test runner can place them on another
worker."""

import json
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

def _tiny_check_phases(monkeypatch):
    """The client_opt and health phases at tiny widths on the CPU: bf16
    compute params over fp32 masters, the kernels' plain versions (so no
    launch rule), host-clock events."""
    import types

    from deepspeed_tpu_torch.models import llama

    tiny = dict(n_layer=2, d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=256)

    class Event:
        def __init__(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    def tiny_llama(seed):
        model = llama("7b", **tiny)
        return model, model.init_params(torch.Generator().manual_seed(seed))

    def tiny_train_setup(seed, config=None, optimizer=None):
        model = llama("7b", **{**tiny, "max_seq": 128})
        params = model.init_params(torch.Generator().manual_seed(seed))
        engine = chip_smoke._train_engine(model, params, config or chip_smoke.TRAIN_CONFIG,
                                          device="cpu", optimizer=optimizer)
        rng = np.random.default_rng(seed + 2)
        ids = rng.integers(0, tiny["vocab_size"], size=(8, 128))
        return model, engine, {"input_ids": torch.from_numpy(ids)}

    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TEL_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TEL_DTYPE", "fp32")
    monkeypatch.setattr(chip_smoke, "_llama7b", tiny_llama)
    monkeypatch.setattr(chip_smoke, "_train_setup", tiny_train_setup)
    monkeypatch.setattr(chip_smoke, "train_launch_rule", lambda engine: {})
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 4)
    monkeypatch.setattr(chip_smoke, "_serve_prompts", lambda cfg, seed: [
        np.random.default_rng(seed).integers(0, cfg.vocab_size, size=n) for n in (40, 7, 19)])
    monkeypatch.setattr(chip_smoke, "_cuda_event", Event)
    # the tiny model's grad norm is below the cell's clip of 1.0: clip lower
    # so the clip bites, as the clip-twice fault needs
    monkeypatch.setitem(chip_smoke.TRAIN_CONFIG, "gradient_clipping", 0.05)
    return types.SimpleNamespace(tiny=tiny)


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_client_opt_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    """phase_client_opt at a tiny size: the grads handed to the client
    optimizer equal E's plain version's, the masters equal AdamW by hand,
    both planted faults read above 0, E never runs."""
    _tiny_check_phases(monkeypatch)
    state = {}
    chip_smoke.phase_client_opt(state, 0)
    line = _last_line(capsys)
    assert line["phase"] == "client_opt" and line["grads_equal_leaves"] == line["leaves"]
    assert line["hand_adamw_max_abs_diff"] == 0.0
    assert line["fault_lr_factor"] > 0 and line["fault_clip_twice"] > 0
    assert line["clip_coef"] < 1.0
    assert line["losses"][-1] < line["losses"][0]
    assert state["client_opt_launches"]["fused_adam"] == 0


def test_client_opt_phase_fails_on_a_planted_engine_lr(monkeypatch):
    """The engine's WarmupLR factor applied on top of the client update must
    fail the hand check (the fault the phase plants, here put in the engine)."""
    _tiny_check_phases(monkeypatch)
    from deepspeed_tpu_torch.runtime import engine as port_engine
    real = port_engine.DeepSpeedEngine._client_step

    def scaled(self, clipped, targets, params, sen):
        before = {n: t.detach().clone() for n, t in targets.items()}
        real(self, clipped, targets, params, sen)
        f = float(self._lr_fn(self.state.global_steps)) / 3e-4
        for n, t in targets.items():
            t.copy_(before[n] + f * (t - before[n]))

    monkeypatch.setattr(port_engine.DeepSpeedEngine, "_client_step", scaled)
    with pytest.raises(RuntimeError, match="differ from AdamW by hand"):
        chip_smoke.phase_client_opt({}, 0)


def test_health_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    """phase_health at a tiny size: losses and syncs on and off, the
    sentinels against the plain recomputation, the scrapes, the CLI over the
    sampler's JSONL, both planted infs, the bundle, the refused port after
    teardown, and the serve cell's request anatomy through the CLI."""
    _tiny_check_phases(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    state = {}
    try:
        chip_smoke.phase_health(state, 0)
    finally:
        chip_smoke._reset_telemetry()
    line = _last_line(capsys)
    assert line["phase"] == "health" and line["losses_equal"]
    assert line["syncs_on"] == [1] * 5 and line["syncs_off"] == [0] * 5
    assert len(line["sentinels"]) == 3 and line["bundle_valid"]
    assert line["planted_off"] == [0.0, 0.0] and line["planted_on_anomalies"] == 1.0
    assert line["refused_after_teardown"] and len(line["anatomy"]) == line["serve_requests"]
    assert not os.path.exists(chip_smoke.CHECK_DIR)
