"""Phase ``train_gptj`` of ``chip_smoke.py`` at a tiny size on the CPU (bf16
compute params over fp32 masters, the kernels' plain versions, so no launch
rule): a 2-layer GPT-J of 2 heads x 256 through the train phase's
configuration, its losses finite and falling, and first the train_parity
check at 1 layer with C's and D's faults planted above the gradient
limit. Apart from the other phase files so the test runner can place it on
another worker."""

import json

import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = {**chip_smoke.GPTJ_6B_CONFIG, "n_head": 2, "n_embd": 512, "n_inner": 256,
        "vocab_size": 128, "n_positions": 256}


def tiny_gptj(n_layer):
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject.policies import GPTJPolicy
    return CausalLM(GPTJPolicy().zoo_config({**TINY, "n_layer": n_layer}))


def test_train_gptj_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1")
    monkeypatch.setattr(chip_smoke, "_gptj_train_model", tiny_gptj)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    monkeypatch.setattr(chip_smoke, "GPTJ_PARITY_SEQ", 64)
    monkeypatch.setattr(chip_smoke, "GPTJ_TRAIN_LAYERS", 2)
    rules = []
    real_rule = chip_smoke.train_launch_rule
    monkeypatch.setattr(chip_smoke, "train_launch_rule",
                        lambda engine, **kw: rules.append(real_rule(engine, **kw)) or {})
    state = {}
    chip_smoke.phase_train_gptj(state, 0)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
             if x.startswith("{")]
    parity, train = lines[-2], lines[-1]
    assert parity["phase"] == "train_gptj_parity" and parity["layers"] == 1
    assert parity["batch"] == [2, 64] and parity["steps"] == 0
    assert [abs(x["diff"]) <= chip_smoke.PARITY_LOSS_TOL for x in parity["losses"]] == [True]
    assert max(parity["grad_rel_diff_worst"].values()) <= chip_smoke.PARITY_GRAD_TOL
    assert all(f["worst"] > chip_smoke.PARITY_GRAD_TOL
               for f in parity["fault_grad_rel_diff"].values())
    assert set(parity["fault_grad_rel_diff"]) == {"dq_delta_not_subtracted",
                                                  "dkv_last_q_tile_skipped"}
    assert train["phase"] == "train_gptj" and train["head_dim"] == 256
    assert train["layers"] == 2 and len(train["losses"]) == chip_smoke.TRAIN_STEPS
    assert train["losses"][-1] < train["losses"][0]
    # the rule of the 8-layer run: 12 leaves a layer and 5 others, K3 gas
    # times (fused CE "auto" is off on the CPU, so the rule reads 0 here)
    assert rules[0]["fused_adam"] == 12 * 2 + 5
    assert rules[0]["flash_attention_bwd_dq"] == 2 * 2
    assert set(state["train_gptj_launches"]) >= {"flash_attention_fwd_hd256",
                                                 "flash_attention_bwd_dq_hd256",
                                                 "flash_attention_bwd_dkv_hd256", "fused_adam"}
