"""Phases ``moe_generate`` and ``moe_train`` of ``chip_smoke.py`` at a tiny
size on the CPU (the kernels' plain versions, so no launch counts): a
2-layer MoE model of 8 experts through init_inference + generate, its rows
and teacher-forced logits against the same weights with attention_backend
"xla" under the reference's replayed routing, K5's planted fault above the
limit, the routing tape and its replay; then a 2-layer MoE model through
the train phase's configuration at micro 2 x gas 2 with the train rule of
the MoE tree (17 leaves a layer, 4 others, no K3). Apart from the other
phase files so the test runner can place it on another worker."""

import json

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def tiny_moe(n_layer):
    from deepspeed_tpu_torch.models.moe_lm import MoECausalLM, MoEConfig
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(**{**chip_smoke.MOE_350M_128, "n_layer": n_layer, "d_model": 128,
                               "n_head": 2, "vocab_size": 96, "max_seq": 256})
    return MoECausalLM(cfg, MoEConfig(**{**chip_smoke.MOE_128, "num_experts": 8}))


def _json_lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


@pytest.fixture
def cpu_phases(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DTYPE", "fp32")
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1")
    monkeypatch.setattr(chip_smoke, "_moe350m", tiny_moe)


def test_moe_generate_phase_runs_its_checks_on_the_cpu(cpu_phases, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "MOE_GENERATE_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "MOE_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "MOE_PROMPT", 128)
    monkeypatch.setattr(chip_smoke, "MOE_MAX_NEW", 6)
    monkeypatch.setattr(chip_smoke, "MOE_LOGIT_ROWS", (0, 2))
    state = {}
    chip_smoke.phase_moe_generate(state, 0)
    line = _json_lines(capsys)[-1]
    assert line["phase"] == "moe_generate" and line["layers"] == 2 and line["experts"] == 8
    assert line["batch"] == [4, 128] and line["max_new_tokens"] == 6
    assert line["expert_counts"]["capacity"] == 4 * 128 // 8
    assert len(line["expert_counts"]["max"]) == 2 and sum(line["expert_counts"]["layer0"]) == 512
    share = line["expert_counts"]["share_over_capacity"]
    assert len(share) == 2 and max(share) <= chip_smoke.MOE_MAX_OVER_CAPACITY
    assert line["logits"]["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL
    assert line["logits"]["positions_compared"] == 2 * (128 + 5)
    assert line["logits"]["fault_ulp_err"]["decode_kv_head_shifted"] > chip_smoke.LOGIT_ULP_TOL
    assert all(d["near_tie"] for d in line["rows_parting"].get("replayed_routing", []))
    assert len(line["tokens_rerouted_in_prefill"]) == 2
    assert state["moe_generate_launches"] == {"dense_decode_attention": 0,
                                              "flash_attention_fwd": 0}


def test_routing_replay_reproduces_the_recorded_routing():
    """Replaying a tape routes every call as recorded, whatever the gate
    logits say now: a model whose gate is zeroed still dispatches the
    recorded tokens (and only those)."""
    model = tiny_moe(2)
    params = model.init_params(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 96, size=(2, 16)))
    tape = []
    with chip_smoke.routing_tape(tape):
        want, _ = model.forward(params, toks, train=False)
    assert len(tape) == 2 and tape[0].shape == (32, 8, 4)       # capacity 32 / 8 = 4
    with chip_smoke.routing_tape(tape, replay=True):
        got, _ = model.forward(params, toks, train=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for lp in params["layers"]:
        lp["mlp"]["gate_w"].data.zero_()
    replayed = []
    with chip_smoke.routing_tape(tape, replay=True):
        with chip_smoke.routing_tape(replayed):
            model.forward(params, toks, train=False)
    assert all(torch.equal(a, b) for a, b in zip(replayed, tape))


def test_moe_train_phase_runs_its_checks_on_the_cpu(cpu_phases, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    rules = []
    real_rule = chip_smoke.train_launch_rule
    monkeypatch.setattr(chip_smoke, "train_launch_rule",
                        lambda engine, **kw: rules.append(real_rule(engine, **kw)) or {})
    state = {}
    chip_smoke.phase_moe_train(state, 0)
    line = _json_lines(capsys)[-1]
    assert line["phase"] == "moe_train" and line["layers"] == 2
    assert len(line["losses"]) == chip_smoke.TRAIN_STEPS
    assert line["losses"][-1] < line["losses"][0] and np.isfinite(line["aux_loss_after"])
    assert line["config"]["train_micro_batch_size_per_gpu"] == 2
    assert rules[0]["fused_adam"] == 17 * 2 + 4 and rules[0]["fused_ce_fwd"] == 0
    assert rules[0]["flash_attention_fwd"] == 2 * 2 * 2
    assert set(state["moe_train_launches"]) >= {"flash_attention_fwd", "flash_attention_bwd_dq",
                                                "flash_attention_bwd_dkv", "fused_adam"}
