"""Phase ``telemetry`` of ``chip_smoke.py`` at a tiny size on the CPU, on a
virtual event clock. Apart from ``test_torch_chip_smoke.py`` so the test
runner can place it on another worker."""

import json
import time

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


# ---- phase telemetry at a tiny size ----

class _VirtualClock:
    """The serving code's event clock in the telemetry phase's CPU test:
    ``monotonic_ns`` moves only when planted device time is paid at a token
    read, so the clock check reads the same on a loaded machine as on an
    idle one (``perf_counter`` stays the host's)."""

    def __init__(self):
        self.ns = time.monotonic_ns()
        self.pending_ms = []

    def monotonic_ns(self):
        return self.ns

    def perf_counter(self):
        return time.perf_counter()

    def pay(self):
        while self.pending_ms:
            self.ns += int(self.pending_ms.pop() * 1e6)


def test_telemetry_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    """phase_telemetry at tiny widths on the CPU (fp32, no kernels, so no
    launch rule): tokens and train losses equal with telemetry on and off,
    the registry's counters, the snapshot and the trace valid, the
    host-sync budget, the decode clock sound and its early-clock copy
    caught (the planted device time is paid at the next token read, as on
    the card, on a virtual clock), and train/mfu against the phase's own
    figure under DS_PEAK_TFLOPS."""
    import types

    from deepspeed_tpu_torch.accelerator.cuda_accelerator import CPU_Accelerator
    from deepspeed_tpu_torch.inference import engine as ie
    from deepspeed_tpu_torch.inference import scheduler as sched
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.monitor import events

    tiny = dict(n_layer=2, d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=256)
    clock = _VirtualClock()
    read = CPU_Accelerator.to_host

    def to_host(self, t):
        clock.pay()                          # queued device time lands before the read
        return read(self, t)

    class Event:
        def __init__(self):
            self.ns = clock.ns

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.ns - self.ns) / 1e6

    def tiny_llama(seed):
        model = llama("7b", **tiny)
        return model, model.init_params(torch.Generator().manual_seed(seed))

    def tiny_train_setup(seed, config=None):
        model = llama("7b", **{**tiny, "max_seq": 128})
        params = model.init_params(torch.Generator().manual_seed(seed))
        engine = chip_smoke._train_engine(model, params, config, device="cpu")
        rng = np.random.default_rng(seed + 2)
        ids = rng.integers(0, tiny["vocab_size"], size=(config["train_batch_size"], 128))
        return model, engine, {"input_ids": torch.from_numpy(ids)}

    vtime = types.SimpleNamespace(monotonic_ns=clock.monotonic_ns,
                                  perf_counter=clock.perf_counter)
    for module in (ie, sched, events, chip_smoke):
        monkeypatch.setattr(module, "time", vtime)
    monkeypatch.setattr(CPU_Accelerator, "to_host", to_host)
    monkeypatch.setattr(chip_smoke, "TEL_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TEL_DTYPE", "fp32")
    monkeypatch.setitem(chip_smoke.TRAIN_CONFIG, "bf16", {"enabled": False})
    monkeypatch.setattr(chip_smoke, "_llama7b", tiny_llama)
    monkeypatch.setattr(chip_smoke, "_train_setup", tiny_train_setup)
    monkeypatch.setattr(chip_smoke, "train_launch_rule", lambda engine: {})
    no_kernels = {"flash_attention_fwd": 0, "paged_decode_attention": 0}
    monkeypatch.setattr(chip_smoke, "serve_launch_rule", lambda cfg, actions: no_kernels)
    monkeypatch.setattr(chip_smoke, "registry_launch_rule", lambda cfg, counters: no_kernels)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 4)
    monkeypatch.setattr(chip_smoke, "CLOCK_MAX_NEW", 4)
    monkeypatch.setattr(chip_smoke, "_serve_prompts", lambda cfg, seed: [
        np.random.default_rng(seed).integers(0, cfg.vocab_size, size=n) for n in (40, 7)])
    monkeypatch.setattr(chip_smoke, "_cuda_event", Event)
    monkeypatch.setattr(chip_smoke, "_device_sleep_fn",
                        lambda ms: (lambda: clock.pending_ms.append(ms)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1e-3")
    chip_smoke._reset_telemetry()
    try:
        chip_smoke.phase_telemetry({}, 0)
    finally:
        from deepspeed_tpu_torch.monitor import get_flight_recorder
        get_flight_recorder().disable()
        chip_smoke._reset_telemetry()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "telemetry" and line["rows_equal"] == line["requests"] == 2
    assert line["trace_valid"] and line["ttft_ms"]["count"] == 2
    assert line["train_losses_equal"] and line["train_syncs_on"] == [1, 1, 1]
    assert line["train_syncs_off"] == [0, 0, 0]
    assert line["decode_clock_ratio"] == 1.0 and line["fault_early_clock_ratio"] == 0.0
    assert line["train_mfu_gauge"] == pytest.approx(line["train_mfu_own"], rel=0.03)
