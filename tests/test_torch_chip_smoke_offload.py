"""Phases ``serve_stream``, ``serve_stream_nvme`` and ``train_offload`` of
``chip_smoke.py`` at a tiny size on the CPU (the kernels' plain versions,
so every launch rule reads 0): a 3-layer Llama streamed from host RAM row
for row and logit for logit equal to the resident engine, the swapped-
layers fault above the limit; the same streamed from NVMe equal to host RAM
with its swap dir gone after release; ZeRO-Offload against the device
optimizer (grads equal, masters within the limit), the masters following
load_module_state_dict and the not-refreshed fault above the limit, NVMe
bit-equal to cpu mode. Apart from the other phase files so the test
runner can place it on another worker."""

import json

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = dict(d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=256)


def tiny_llama(seed, n_layer=None):
    from deepspeed_tpu_torch.models import llama
    model = llama("7b", n_layer=n_layer or 3, **TINY)
    return model, model.init_params(torch.Generator().manual_seed(seed), dtype=torch.bfloat16)


def tiny_offload_model(n_layer):
    from deepspeed_tpu_torch.models import llama
    return llama("7b", n_layer=n_layer, **TINY)


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "_stream_model", tiny_llama)
    monkeypatch.setattr(chip_smoke, "GEN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "GEN_PROMPT", 20)
    monkeypatch.setattr(chip_smoke, "STREAM_MAX_NEW", 4)
    monkeypatch.setattr(chip_smoke, "STREAM_LAYERS", 3)
    monkeypatch.setattr(chip_smoke, "STREAM_NVME_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "STREAM_DIR", str(tmp_path / "zi"))
    monkeypatch.setattr(chip_smoke, "OFFLOAD_DIR", str(tmp_path / "off"))
    monkeypatch.setattr(chip_smoke, "_offload_model", tiny_offload_model)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "OFFLOAD_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "OFFLOAD_CHECK_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "OFFLOAD_NVME_LAYERS", 1)
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1")
    return tmp_path


def _last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_stream_phase_runs_its_checks_on_the_cpu(small, capsys):
    state = {}
    chip_smoke.phase_serve_stream(state, 0)
    line = _last(capsys)
    assert line["phase"] == "serve_stream" and line["layers"] == 3
    assert line["rows_equal"] == line["rows"] == 2
    assert line["teacher_forced"]["ulp_err"] == 0.0
    assert line["teacher_forced"]["fault_ulp_err"]["layers_0_1_swapped"] > \
        chip_smoke.LOGIT_ULP_TOL
    assert line["streamed"]["launches"] == {"dense_decode_attention": 0,
                                            "flash_attention_fwd": 0}
    assert state["serve_stream_launches"] == {"dense_decode_attention": 0}


def test_serve_stream_nvme_phase_runs_its_checks_on_the_cpu(small, capsys):
    state = {}
    chip_smoke.phase_serve_stream_nvme(state, 0)
    line = _last(capsys)
    assert line["phase"] == "serve_stream_nvme" and line["layers"] == 2
    assert line["rows_equal"] == line["rows"] == 2
    assert line["swap_dir_removed"] and line["read"]["gb_per_s"] > 0
    assert not (small / "zi").exists()


def test_train_offload_phase_runs_its_checks_on_the_cpu(small, capsys, monkeypatch):
    # the plain versions launch nothing on the CPU: the rule is recorded and
    # held to 0 here
    rules = []
    real_rule = chip_smoke.offload_launch_rule
    monkeypatch.setattr(chip_smoke, "offload_launch_rule",
                        lambda e: {k: 0 for k in rules.append(real_rule(e)) or rules[-1]})
    state = {}
    chip_smoke.phase_train_offload(state, 0)
    line = _last(capsys)
    assert line["phase"] == "train_offload" and line["layers"] == 2
    assert len(line["losses"]) == chip_smoke.TRAIN_STEPS
    assert line["losses"][-1] < line["losses"][0]
    assert line["grads_equal_leaves"] == 9 * 2 + 3
    assert line["master_err_worst"] <= chip_smoke.MASTER_TOL
    assert line["reload_err"] == 0.0
    assert line["fault_masters_not_refreshed"] > chip_smoke.MASTER_TOL
    assert line["nvme_bit_equal"] and line["nvme_losses"] == line["cpu_losses"]
    assert set(line["split"]) == {"accumulation_ms", "d2h_ms", "host_ms", "h2d_ms"}
    assert line["split"]["host_ms"] > 0 and line["split"]["accumulation_ms"] > 0
    assert rules[0]["fused_adam"] == 0 and rules[0]["flash_attention_fwd"] == 2 * 2 * 2
    assert rules[0]["flash_attention_bwd_dq"] == 2 * 2 and rules[0]["fused_ce_fwd"] == 2
    assert not (small / "off").exists()
