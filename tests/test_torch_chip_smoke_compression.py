"""The compression phases of ``chip_smoke.py`` (``compress_parity``,
``compress_train``, ``moq_eigenvalue``) at a tiny size on the CPU:
BERT-large's and Llama-2-7B's configurations cut to a few narrow layers,
the kernels' plain versions on both sides (the launch rules checked as
functions), every planted fault reading above its limit, and each phase's
gates and record."""

import copy
import json

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def tiny_bert(n_layer=None, **over):
    from deepspeed_tpu_torch.models import BertConfig, BertModel
    over = {"attention_backend": "flash", **over}
    cfg = BertConfig(vocab_size=1200, max_seq=256, n_layer=n_layer or 24, n_head=2, d_model=32,
                     d_ff=64, **over)
    return BertModel(cfg, with_mlm_head=True)


def tiny_llama(n_layer=1, **over):
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    kw = dict(vocab_size=256, n_layer=n_layer, n_head=4, d_model=64, d_ff=128, max_seq=256,
              pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
              norm_eps=1e-6, attention_backend="flash")
    return CausalLM(TransformerConfig(**{**kw, **over}))


@pytest.fixture
def tiny(monkeypatch):
    cfg = copy.deepcopy(chip_smoke.COMPRESS_CONFIG)
    cfg["compression_training"]["weight_quantization"]["shared_parameters"][
        "quantize_groups"] = 4
    monkeypatch.setattr(chip_smoke, "COMPRESS_CONFIG", cfg)
    monkeypatch.setattr(chip_smoke, "COMPRESS_GROUPS", 4)
    monkeypatch.setattr(chip_smoke, "COMPRESS_PARITY_ACT_BITS", 2)   # narrow: a coarser grid
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "bert_large", tiny_bert)
    monkeypatch.setattr(chip_smoke, "compress_llama", tiny_llama)
    monkeypatch.setattr(chip_smoke, "BERT_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "BERT_PARITY_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BERT_FULL_ROWS", 1)
    monkeypatch.setattr(chip_smoke, "BERT_MICRO", 4)
    monkeypatch.setattr(chip_smoke, "BERT_SERVE_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "COMPRESS_SERVE_REQUESTS", 6)
    monkeypatch.setattr(chip_smoke, "COMPRESS_LLAMA_PARITY", (2, 32))
    monkeypatch.setattr(chip_smoke, "COMPRESS_ACT_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "EV_PARITY_BATCH", (2, 128))
    monkeypatch.setattr(chip_smoke, "COMPRESS_MLP_SCALE", 8.0)   # d 32: the MLP's output small
    monkeypatch.setattr(chip_smoke, "MOQ_EV_MICRO", 2)
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1")


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def test_compress_parity_runs_and_its_faults_bite(tiny, capsys):
    chip_smoke.phase_compress_parity({}, seed=0)
    recs = {r.get("check", r["phase"]): r for r in _lines(capsys)}
    leaves = recs["bert_leaves"]["techniques"]
    assert all(v["elements_differing"] == 0 for v in leaves.values() if isinstance(v, dict))
    assert leaves["sparse_mlp"]["fault_threshold_k_plus_1"] > 0
    assert leaves["head_pruning_stacked_raises"] == ["ZeroDivisionError"] * 2
    assert recs["bert_forward"]["fault_ulp_err"]["sparse_mask_left_out"] > chip_smoke.LOGIT_ULP_TOL
    grads = recs["compress_parity_bert_grads"]
    assert grads["fault_grad_rel_diff"]["ste_zero_gradient"]["worst"] > chip_smoke.PARITY_GRAD_TOL
    assert recs["llama"]["leaves_fp32_differing"] == 0
    llama = recs["llama"]["forward"]
    assert llama["fault_ulp_err"]["mlp_act_quant_left_out"] > chip_smoke.LOGIT_ULP_TOL
    assert recs["act_quant_engine"]["act_bits_by_step"] == [0, 8, 8]
    ev = recs["eigenvalue"]
    assert max(ev["rel_diff"]) <= chip_smoke.EV_ITER_TOL < ev["fault_mask_not_applied_rel"]


def test_compress_train_runs_the_recipe(tiny, capsys):
    state = {}
    chip_smoke.phase_compress_train(state, seed=0)
    rec = _lines(capsys)[-1]
    assert rec["phase"] == "compress_train" and rec["student_layers"] == 12
    assert [a["sparse_pruning"] for a in rec["active_by_step"]] == [False] * 4 + [True] * 2
    assert all(a["weight_quantization"] for a in rec["active_by_step"])
    assert rec["top1_differ"] == 0 and rec["masked_positions"] > 0
    assert rec["losses"][-1] < rec["losses"][0]
    assert set(state["compress_train_launches"]) >= {"fused_adam", "flash_attention_fwd_bert"}


def test_moq_eigenvalue_runs_the_schedule(tiny, capsys):
    state = {}
    chip_smoke.phase_moq_eigenvalue(state, seed=0)
    rec = _lines(capsys)[-1]
    assert rec["phase"] == "moq_eigenvalue" and len(rec["eigen"]) == chip_smoke.MOQ_EV_STEPS
    assert all(len(e["block_eigenvalues"]) == 24 and max(e["block_eigenvalues"]) == 1.0
               for e in rec["eigen"])
    assert rec["n_switches"] > 0
    assert any(s["factor"] > 1 for s in rec["switches"])


def test_launch_rules():
    class Engine:
        class module:
            class config_model:
                n_layer = 3

        class state:
            params = tiny_bert(3).init_params()
    rule = chip_smoke.compress_train_launch_rule(Engine)
    assert rule["fused_adam"] == 16 * 3 + 12
    assert rule["flash_attention_fwd"] == rule["flash_attention_bwd_dkv"] == 3
    assert rule["fused_ce_dw_gemm"] == 1
    moq = chip_smoke.moq_launch_rule(Engine)
    assert moq["fused_adam"] == 16 * 3 + 12
    # the stacked layer leaves (16 a layer) and the 2-D non-layer leaves
    # (embed tokens, positions, token_type, pooler w, mlm w)
    assert moq["sr_quantize"] == moq["sr_absmax"] == 16 * 3 + 5
    assert moq["flash_attention_fwd"] == moq["fused_ce_fwd"] == 0
