"""The training-extras phases of ``chip_smoke.py`` (``train_remat``,
``train_data_efficiency``) at a tiny size on the CPU: the train cell's and
BERT-large's configurations cut to narrow layers and short sequences, the
kernels' plain versions, each phase's gates and record, and a planted
fault for each (a policy that keeps nothing, a curriculum that cuts
nothing) failing its phase."""

import copy
import json

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def tiny_llama():
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    return CausalLM(TransformerConfig(
        vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=128, max_seq=64,
        pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
        norm_eps=1e-6, attention_backend="flash"))


def tiny_bert(n_layer=None, **over):
    from deepspeed_tpu_torch.models import BertConfig, BertModel
    over = {"attention_backend": "flash", **over}
    cfg = BertConfig(vocab_size=1200, max_seq=128, n_layer=n_layer or 6, n_head=2, d_model=32,
                     d_ff=64, **over)
    return BertModel(cfg, with_mlm_head=True)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "remat_llama", tiny_llama)
    monkeypatch.setattr(chip_smoke, "REMAT_SEQ", 64)
    monkeypatch.setattr(chip_smoke, "bert_large", tiny_bert)
    monkeypatch.setattr(chip_smoke, "BERT_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "BERT_MICRO", 4)
    monkeypatch.setattr(chip_smoke, "DE_SAMPLES", 64)
    curriculum = {**copy.deepcopy(chip_smoke.DE_CURRICULUM), "min_difficulty": 32,
                  "max_difficulty": 128}
    monkeypatch.setattr(chip_smoke, "DE_CURRICULUM", curriculum)
    ltd = copy.deepcopy(chip_smoke.DE_LTD)
    ltd["random_ltd_schedule"].update(min_value=16, max_value=128)
    ltd["random_ltd_schedule"]["schedule_config"]["seq_per_step"] = 4
    monkeypatch.setattr(chip_smoke, "DE_LTD", ltd)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def test_train_remat_runs_each_policy(tiny, capsys):
    state = {}
    chip_smoke.phase_train_remat(state, seed=0)
    rec = _lines(capsys)[-1]
    assert rec["phase"] == "train_remat"
    assert {p: c["elements_differing"] for p, c in rec["grad_check"].items()} == dict.fromkeys(
        chip_smoke.REMAT_POLICIES, 0)
    assert [rec["grad_check"][p]["a_in_backward"] for p in chip_smoke.REMAT_POLICIES] == \
        [[2, 2], [0, 0], [2, 2], [2, 2]]
    runs = rec["policies"]
    assert set(runs) == set(chip_smoke.REMAT_POLICIES)
    assert runs["full"]["saved_gb_a_step"] == 0 < runs["selective"]["saved_gb_a_step"] \
        < runs["dots"]["saved_gb_a_step"] == runs["offload_dots"]["saved_gb_a_step"]
    assert set(state["train_remat_launches"]) >= {"flash_attention_fwd", "fused_adam"}


def test_train_remat_fails_when_selective_keeps_nothing(tiny, monkeypatch):
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
    monkeypatch.setattr(ck, "_saves", lambda policy, func: False)
    with pytest.raises(RuntimeError, match="selective: A ran"):
        chip_smoke.phase_train_remat({}, seed=0)


def test_reckoned_bytes_at_the_train_cell():
    from deepspeed_tpu_torch.models import llama
    got = chip_smoke.remat_reckoned_gb(llama("7b", n_layer=8).config, 4 * 2048)
    assert got["selective"] == pytest.approx(3.229, abs=1e-3)
    assert got["dots"] == pytest.approx(5.570, abs=1e-3)
    assert got["offload_dots"] == 0


def test_train_data_efficiency_follows_the_schedulers(tiny, capsys):
    state = {}
    chip_smoke.phase_train_data_efficiency(state, seed=0)
    rec = _lines(capsys)[-1]
    assert rec["phase"] == "train_data_efficiency"
    steps = rec["steps"]
    assert [s["S"] for s in steps] == [56, 72, 96, 112, 128, 128]
    assert [s["keep"] for s in steps] == [20, 24, 32, 36, 44, 48]
    assert rec["theta"][0] < 1.0 and rec["theta"] == sorted(rec["theta"], reverse=True)
    assert rec["rows_short"] == 16
    assert set(state["train_data_efficiency_launches"]) >= {"flash_attention_fwd_ltd",
                                                            "fused_adam"}
    assert not chip_smoke.os.path.exists(chip_smoke.DE_DIR)


def test_train_data_efficiency_fails_without_the_cut(tiny, monkeypatch):
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    monkeypatch.setattr(DeepSpeedEngine, "_curriculum_truncate", lambda self, batch: batch)
    with pytest.raises(RuntimeError, match="train_data_efficiency failed: step 1"):
        chip_smoke.phase_train_data_efficiency({}, seed=0)
