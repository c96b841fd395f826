"""Phase ``serve_int8`` of ``chip_smoke.py`` at a tiny size on the CPU (the
kernels' plain versions, so every launch rule reads 0): a 2-layer Llama
served with dtype "int8", its weights at rest below the bf16 engine's, the
run with the dequant's plain twin row for row and logit for logit equal,
the planted fault above the limit, the bf16 engine's top-1 agreement
reported. Apart from the other phase files so the test runner can place it
on another worker."""

import json

import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = dict(n_layer=2, d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=1024)


def tiny_llama(seed):
    from deepspeed_tpu_torch.models import llama
    model = llama("7b", **TINY)
    return model, model.init_params(torch.Generator().manual_seed(seed))


def test_serve_int8_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DTYPE", "fp32")
    monkeypatch.setattr(chip_smoke, "_llama7b", tiny_llama)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 6)
    state = {}
    chip_smoke.phase_serve_int8(state, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_int8" and line["dtype"] == "int8"
    assert line["q_groups"] == 1 and line["requests"] == 12
    assert line["at_rest"]["int8_tree_gb"] < line["at_rest"]["bf16_tree_gb"]
    assert line["serve"]["generated_tokens"] == line["bf16_serve"]["generated_tokens"] == 72
    assert line["twin"]["rows_equal"] == 12 and line["twin"]["logits"]["ulp_err"] == 0.0
    assert line["twin"]["logits"]["fault_ulp_err"]["flash_kv_head_shifted"] > \
        chip_smoke.LOGIT_ULP_TOL
    assert 0 < line["bf16_top1_agreement"]["positions"] == 4 * 6
    assert state["serve_int8_launches"] == {"flash_attention_fwd": 0,
                                            "paged_decode_attention": 0, "dequant_int8": 0}
