"""Phase ``serve_gptj`` of ``chip_smoke.py`` at a tiny size on the CPU
(fp32, the kernels' plain versions, so no launch rule): a 2-layer GPT-J of
2 heads x 256 through generate_batch and static generate, rows and
teacher-forced logits against the same weights with attention_backend
"xla", the planted fault above the limit. Apart from the other phase files
so the test runner can place it on another worker."""

import json

import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = {**chip_smoke.GPTJ_6B_CONFIG, "n_layer": 2, "n_head": 2, "n_embd": 512,
        "n_inner": 256, "vocab_size": 128, "n_positions": 1024}


def tiny_gptj(seed):
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject.policies import GPTJPolicy
    model = CausalLM(GPTJPolicy().zoo_config(TINY))
    params = model.init_params(torch.Generator().manual_seed(seed))
    params["lm_head_bias"].data.normal_(0.0, 0.1)
    return model, params


def test_serve_gptj_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DTYPE", "fp32")
    monkeypatch.setattr(chip_smoke, "_gptj6b", tiny_gptj)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 6)
    state = {}
    chip_smoke.phase_serve_gptj(state, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_gptj" and line["head_dim"] == 256
    assert line["rotary_dim"] == 64 and line["requests"] == 12
    assert line["serve"]["generated_tokens"] == 12 * 6
    assert line["serve"]["ttft_ms"]["count"] == 12
    assert line["logits"]["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL
    assert line["logits"]["fault_ulp_err"]["flash_kv_head_shifted"] > chip_smoke.LOGIT_ULP_TOL
    assert all(d["near_tie"] for d in line["rows_parting"] + line["static"]["rows_parting"])
    assert line["static"]["batch"] == [12, chip_smoke.GPTJ_STATIC_PROMPT]
    assert state["serve_gptj_launches"] == {"flash_attention_fwd_hd256": 0,
                                            "paged_decode_attention_hd256": 0,
                                            "dense_decode_attention_hd256": 0}
