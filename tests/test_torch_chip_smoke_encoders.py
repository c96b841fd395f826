"""The encoder phases of ``chip_smoke.py`` (``encoder_parity``,
``bert_serve``, ``bert_train``, ``clip_encode``) at a tiny size on the CPU:
BERT-large's and CLIP ViT-L/14's configurations cut to a few narrow layers
(the same policies build them), the kernels' plain versions on both sides,
so the launch rules are checked as functions. Covers the fill-mask batches
and prompts (the masking rule, the padding, CLIP's EOT padding), the HF
checkpoints the phases write (loaded back through the policies, leaf for
leaf), every planted fault of encoder_parity reading above its limit on the
plain versions, and each phase's gates and record."""

import json

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def tiny_bert(n_layer=None, **over):
    """BERT-large's configuration cut narrow; attention "flash" so the CPU
    runs the kernels' plain versions (with a layout too) where the card
    runs the kernels, and the planted faults reach them."""
    from deepspeed_tpu_torch.models import BertConfig, BertModel
    cfg = BertConfig(vocab_size=1200, max_seq=256, n_layer=n_layer or 2, n_head=2, d_model=32,
                     d_ff=64, attention_backend="flash", **over)
    return BertModel(cfg, with_mlm_head=True)


def tiny_clip(text_layers=None, vision_layers=None):
    from deepspeed_tpu_torch.models import clip
    text = clip.CLIPTextEncoder(clip.CLIPTextConfig(
        vocab_size=49408, max_seq=77, n_layer=text_layers or 2, n_head=2, d_model=32, d_ff=64,
        projection_dim=16))
    vision = clip.CLIPVisionEncoder(clip.CLIPVisionConfig(
        image_size=28, patch_size=14, n_layer=vision_layers or 2, n_head=2, d_model=32, d_ff=64,
        projection_dim=16))
    return clip.DSClipEncoder(text, vision)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "bert_large", tiny_bert)
    monkeypatch.setattr(chip_smoke, "clip_l14", tiny_clip)
    monkeypatch.setattr(chip_smoke, "ENCODER_DIR", str(tmp_path / "enc"))
    monkeypatch.setattr(chip_smoke, "BERT_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "BERT_PARITY_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BERT_FULL_ROWS", 1)
    monkeypatch.setattr(chip_smoke, "BERT_SPARSE_SEQ", 1024)
    monkeypatch.setattr(chip_smoke, "BERT_MICRO", 4)
    monkeypatch.setattr(chip_smoke, "BERT_SERVE_REQUESTS", 6)
    monkeypatch.setattr(chip_smoke, "BERT_SERVE_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "CLIP_PROMPTS", 6)
    monkeypatch.setattr(chip_smoke, "CLIP_TEXT_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "CLIP_IMAGES", 3)
    monkeypatch.setattr(chip_smoke, "CLIP_IMAGE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "CLIP_PARITY_TEXT", 2)
    monkeypatch.setattr(chip_smoke, "CLIP_PARITY_IMAGES", 2)
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1")


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def test_mlm_batch_masking_rule_and_padding():
    batch, lengths = chip_smoke.mlm_batch(30522, 8, 512, seed=3)
    ids, mask, labels = batch["input_ids"], batch["attention_mask"], batch["labels"]
    assert ids.shape == mask.shape == labels.shape == (8, 512)
    assert ((64 <= lengths) & (lengths <= 512)).all()
    assert (mask.sum(1) == lengths).all() and (ids[mask == 0] == 0).all()
    assert (ids[:, 0] == chip_smoke.BERT_CLS).all()
    assert (ids[np.arange(8), lengths - 1] == chip_smoke.BERT_SEP).all()
    masked = labels != -100
    assert (ids[masked] == chip_smoke.BERT_MASK).all() and (mask[masked] == 1).all()
    assert not masked[:, 0].any() and not masked[np.arange(8), lengths - 1].any()
    assert (labels[masked] >= 1000).all()
    share = masked.sum() / (lengths - 2).sum()
    assert 0.12 < share < 0.18
    # within the gather budget at the bench's micro-batch
    big, _ = chip_smoke.mlm_batch(30522, 32, 512, seed=4)
    assert (big["labels"] != -100).sum() < chip_smoke.BERT_BUDGET * 32 * 512
    same, _ = chip_smoke.mlm_batch(30522, 8, 512, seed=3)
    assert all((same[k] == batch[k]).all() for k in batch)
    # the gradient check's full-length rows hold masked labels in their last q tile
    full, lengths = chip_smoke.mlm_batch(30522, 4, 512, seed=5, full_rows=3)
    assert (lengths[:3] == 512).all() and lengths[3] < 512
    assert ((full["labels"][:3, -64:] != -100).sum(1) > 0).all()


def test_clip_prompts_pad_with_eot_and_pool_at_the_first():
    ids = chip_smoke.clip_prompts(6, seed=5)
    assert ids.shape == (6, 77) and (ids[:, 0] == chip_smoke.CLIP_BOS).all()
    first = (ids == chip_smoke.CLIP_EOT).argmax(1)
    assert (first >= 7).all()
    for row, f in zip(ids, first):     # EOT to the end: the argmax rule pools at the first
        assert (row[f:] == chip_smoke.CLIP_EOT).all() and (row[1:f] < chip_smoke.CLIP_BOS).all()
    assert chip_smoke.clip_images(2, 1).shape == (2, 224, 224, 3)


def test_launch_rules():
    assert chip_smoke.bert_serve_launch_rule(24, 4) == {
        "flash_attention_fwd": 96, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
        "fused_ce_fwd": 0, "fused_ce_ds": 0, "fused_ce_dh_gemm": 0, "fused_ce_dw_gemm": 0}
    assert chip_smoke.clip_launch_rule(12, 24, 4, 4) == {"text": 48, "image": 96}

    class Engine:
        module = tiny_bert(3)

        class state:
            params = tiny_bert(3).init_params()
    rule = chip_smoke.bert_train_launch_rule(Engine)
    assert rule["fused_adam"] == 16 * 3 + 12
    assert rule["flash_attention_fwd"] == rule["flash_attention_bwd_dq"] == 3
    assert rule["fused_ce_fwd"] == rule["fused_ce_dw_gemm"] == 1


def test_full_size_configurations_are_the_published_ones():
    bert = chip_smoke.bert_large(mlm_gather_budget=0.25)
    c = bert.config
    assert (c.n_layer, c.d_model, c.n_head, c.d_ff, c.vocab_size, c.max_seq) == \
        (24, 1024, 16, 4096, 30522, 512)
    assert c.activation == "gelu_exact" and c.norm_eps == 1e-12 and bert.with_mlm_head
    assert bert.num_parameters == 336_224_058     # 335.1 M of BertForMaskedLM + the pooler
    enc = chip_smoke.clip_l14()
    t, v = enc.text.config, enc.vision.config
    assert (t.n_layer, t.d_model, t.n_head, t.d_ff, t.vocab_size, t.max_seq, t.projection_dim,
            t.eos_token_id) == (12, 768, 12, 3072, 49408, 77, 768, 2)
    assert (v.n_layer, v.d_model, v.n_head, v.d_ff, v.image_size, v.patch_size,
            v.projection_dim, v.n_patches) == (24, 1024, 16, 4096, 224, 14, 768, 256)
    assert t.activation == v.activation == "quick_gelu"
    # the config.json files the phases write are the published ones
    assert chip_smoke.bert_hf_config(c) == chip_smoke.BERT_LARGE_HF
    assert chip_smoke.clip_hf_config(enc) == chip_smoke.CLIP_L14_HF


def test_checkpoint_entries_load_back_through_the_policies(tmp_path):
    from deepspeed_tpu_torch.models.transformer import ParamTree
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
    bert = tiny_bert()
    params = bert.init_params(torch.Generator().manual_seed(0))
    for leaf in params["pooler"].parameters():
        leaf.data.zero_()
    hf = chip_smoke.bert_hf_config(bert.config)
    chip_smoke.write_hf_checkpoint(str(tmp_path / "b"), hf,
                                   chip_smoke.bert_hf_entries(params, torch.float32))
    model, got = load_hf_checkpoint(str(tmp_path / "b"))
    assert type(model).__name__ == "BertModel" and model.with_mlm_head
    assert chip_smoke._equal_leaves(got, params) == []
    enc = tiny_clip()
    g = torch.Generator().manual_seed(1)
    tree = ParamTree({"text": enc.text.init_params(g).to_dict(),
                      "vision": enc.vision.init_params(g).to_dict(),
                      "logit_scale": torch.tensor(2.6592)})
    hf = chip_smoke.clip_hf_config(enc)
    chip_smoke.write_hf_checkpoint(str(tmp_path / "c"), hf,
                                   chip_smoke.clip_hf_entries(tree, torch.float32, 14))
    model, got = load_hf_checkpoint(str(tmp_path / "c"))
    assert type(model).__name__ == "DSClipEncoder"
    assert chip_smoke._equal_leaves(got, tree) == []


def test_encoder_parity_phase_on_the_cpu(tiny, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "ENCODER_DTYPE", "bf16")
    chip_smoke.phase_encoder_parity({}, 0)
    lines = {x.get("check", x["phase"]): x for x in _lines(capsys)}
    fwd = lines["bert_forward"]
    assert fwd["mlm_logits"]["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL
    assert set(fwd["mlm_logits"]["fault_ulp_err"]) == {"padding_mask_dropped", "causal",
                                                        "kv_head_shifted"}
    assert min(fwd["mlm_logits"]["fault_ulp_err"].values()) > chip_smoke.LOGIT_ULP_TOL
    grads = lines["encoder_parity_bert_grads"]
    assert grads["steps"] == 0 and grads["batch"] == [2, 128]
    assert set(grads["fault_grad_rel_diff"]) == {"dq_delta_not_subtracted",
                                                 "dkv_delta_not_subtracted",
                                                 "dkv_last_q_tile_skipped",
                                                 "mask_dropped_in_backward"}
    assert all(f["worst"] > chip_smoke.PARITY_GRAD_TOL
               for f in grads["fault_grad_rel_diff"].values())
    sparse = lines["encoder_parity_sparse_bert_grads"]
    assert sparse["batch"] == [2, 1024]
    assert sparse["fault_grad_rel_diff"]["layout_ignored"]["worst"] > chip_smoke.PARITY_GRAD_TOL
    clip = lines["clip_forward"]
    assert clip["text_hidden"]["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL
    assert clip["vision_pooled"]["fault_ulp_err"]["vision_causal"] > chip_smoke.LOGIT_ULP_TOL
    assert clip["text_pooled"]["fault_ulp_err"]["text_non_causal"] > chip_smoke.LOGIT_ULP_TOL


def test_bert_serve_train_and_clip_phases_on_the_cpu(tiny, capsys):
    state = {}
    chip_smoke.phase_bert_serve(state, 0)
    chip_smoke.phase_bert_train(state, 0)
    chip_smoke.phase_clip_encode(state, 0)
    lines = {x["phase"]: x for x in _lines(capsys)}
    serve = lines["bert_serve"]
    assert serve["top1_differ"] == 0 and serve["masked_positions"] > 0
    assert "is an encoder" in serve["generate_refused"]
    assert serve["launch_rule"]["flash_attention_fwd"] == 2 * 2
    train = lines["bert_train"]
    assert len(train["losses"]) == chip_smoke.TRAIN_STEPS
    assert train["losses"][-1] < train["losses"][0]
    assert train["launch_rule"]["fused_adam"] == 16 * 2 + 12
    clip = lines["clip_encode"]
    assert clip["elements_differ"] == {"text": 0, "image": 0}
    assert clip["launch_rule"] == {"text": 2 * 2, "image": 2 * 2}
    assert set(state) == {"bert_serve_launches", "bert_train_launches", "clip_encode_launches"}
    assert not (chip_smoke.os.path.exists(chip_smoke.ENCODER_DIR)
                and chip_smoke.os.listdir(chip_smoke.ENCODER_DIR))
