"""The port's compression (``deepspeed_tpu_torch/compression/``) against the
JAX package's (``deepspeed_tpu/compression/``), the counterpart of
``tests/unit/test_compression.py`` class by class.

Fake-quant (symmetric, asymmetric, grouped, 2-bit, the STE gradient) and
the four masks on the same numpy inputs, bit-equal in fp32, with a planted
tie at the threshold; ``compress_params`` on a 3-layer ``CausalLM`` and on a
``BertModel`` (every technique, each leaf bit-equal to the JAX package's on
its stacked leaf); the compressed loss and gradients within the training
tests' tolerances; the scheduler's active set at each step; layer reduction
and ``student_initialization``; ``redundancy_clean``; head pruning raising
where the JAX package raises; activation fake-quant (the forward, the cached
and the paged paths against the JAX forward); the engine training a
``CompressedModel`` across an activation-quant transition, losses against
the JAX engine's. Weights cross with ``checkpoint/from_jax.py``; inputs are
numpy-seeded; fp32 on both sides."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import compression as JC
from deepspeed_tpu.compression import functional as JF
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.bert import BertConfig as JaxBertConfig
from deepspeed_tpu.models.bert import BertModel as JaxBertModel
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch import compression as PC
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.compression import functional as PF
from deepspeed_tpu_torch.models import BertConfig, BertModel, CausalLM, TransformerConfig

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LOSS_TOL = 1e-5            # relative (tests/test_torch_training.py)
GRAD_TOL = 3e-5            # each leaf's gradient, relative to its largest value
DECODE_TOL = 2e-5          # fp32 logits, port against the JAX forward
GPT2 = dict(vocab_size=64, max_seq=16, n_layer=3, n_head=2, d_model=32, d_ff=64,
            pos_embedding="learned", norm="layernorm", activation="gelu", attn_bias=True,
            tie_embeddings=True, remat=False, attention_backend="xla")
BERT = dict(vocab_size=64, max_seq=16, n_layer=3, n_head=2, d_model=32, d_ff=64, remat=False,
            attention_backend="xla")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _seeded(tree, seed=0):
    """The init's zero biases and unit norm scales made seeded values, so
    that a transform of the stacked [L, D] leaves shows."""
    r = _rng(seed + 100)

    def one(path, a):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if a.ndim >= 1 and ("scale" in key or "'b" in key or "bias" in key):
            return (a + 0.1 * r.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


def _pair(**over):
    kw = {**GPT2, **over}
    jm = JaxCausalLM(JT.TransformerConfig(**kw))
    jp = _seeded(jm.init_params(jax.random.key(0)))
    pm = CausalLM(TransformerConfig(**kw))
    return jm, jp, pm, params_from_jax(pm.config, jp)


def _bert_pair(**over):
    jm = JaxBertModel(JaxBertConfig(**BERT, **over), with_mlm_head=True)
    jp = _seeded(jm.init_params(jax.random.key(0)))
    pm = BertModel(BertConfig(**BERT, **over), with_mlm_head=True)
    return jm, jp, pm, params_from_jax(pm.config, jp)


def _equal(got, want):
    """Every leaf of the port's tree bit-equal to the JAX tree's."""
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                 got, jax.tree.map(np.asarray, want))


def _group(technique, params=None, modules=None, **shared):
    g = {"params": params or {}}
    if modules is not None:
        g["modules"] = modules
    return {"compression_training": {technique: {
        "shared_parameters": {"enabled": True, "schedule_offset": 0, **shared},
        "different_groups": {"g1": g}}}}


# ------------------------------------------------------------------ #
# fake-quant (TestFakeQuant)

@pytest.mark.parametrize("shape", [(8, 16), (3, 32, 64)])
@pytest.mark.parametrize("bits,sym,groups", [(8, True, 1), (4, False, 1), (8, True, 4),
                                             (2, True, 1), (3, False, 8)])
def test_fake_quantize_bit_equal(shape, bits, sym, groups):
    w = _rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(JF.fake_quantize(jnp.asarray(w), bits, sym, groups))
    got = PF.fake_quantize(torch.as_tensor(w), bits, sym, groups)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PF.quantize_activation(torch.as_tensor(w), bits, sym).numpy(),
                                  np.asarray(JF.quantize_activation(jnp.asarray(w), bits, sym)))


def test_fake_quantize_keeps_bf16_and_the_grid():
    w = _rng(2).standard_normal((4, 64)).astype(np.float32)
    got = PF.fake_quantize(torch.as_tensor(w).bfloat16(), 8, True, 1)
    want = JF.fake_quantize(jnp.asarray(w).astype(jnp.bfloat16), 8, True, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert len(np.unique(PF.fake_quantize(torch.as_tensor(w), 2, True, 1).numpy())) <= 4


def test_ste_gradient_matches_jax():
    w = _rng(3).standard_normal((4, 4)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(JF.fake_quantize(x, 8, True, 1) ** 2))(jnp.asarray(w))
    t = torch.as_tensor(w).requires_grad_(True)
    (PF.fake_quantize(t, 8, True, 1) ** 2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))     # 2 q: the STE


# ------------------------------------------------------------------ #
# masks (TestPruning)

@pytest.mark.parametrize("shape", [(16, 16), (3, 32, 64)])
@pytest.mark.parametrize("fn", ["sparse_mask", "row_mask", "channel_mask"])
@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.9])
def test_masks_bit_equal(fn, shape, ratio):
    w = _rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(JF, fn)(jnp.asarray(w), ratio))
    np.testing.assert_array_equal(getattr(PF, fn)(torch.as_tensor(w), ratio).numpy(), want)


def test_masks_keep_a_planted_tie():
    """Equal magnitudes straddling the threshold are all kept (>=), in both."""
    w = np.tile(np.array([0.5, -0.5, 0.25, 1.0], np.float32), (4, 4))     # [4, 16]
    w[0, 0] = 2.0
    for fn in ("sparse_mask", "row_mask", "channel_mask"):
        want = np.asarray(getattr(JF, fn)(jnp.asarray(w), 0.3))
        got = getattr(PF, fn)(torch.as_tensor(w), 0.3).numpy()
        np.testing.assert_array_equal(got, want)
    kept = PF.sparse_mask(torch.as_tensor(w), 0.3).numpy()
    assert kept.mean() > 0.3 and (kept[np.abs(w) == 1.0] == 1).all()


@pytest.mark.parametrize("H", [2, 4])
def test_head_mask_and_prune_bit_equal(H):
    w = _rng(5).standard_normal((32, 16)).astype(np.float32)
    np.testing.assert_array_equal(PF.head_mask(torch.as_tensor(w), H, 0.5).numpy(),
                                  np.asarray(JF.head_mask(jnp.asarray(w), H, 0.5)))
    for method in ("sparse", "row", "channel", "head"):
        want = JF.prune(jnp.asarray(w), method, 0.5, num_heads=H)
        np.testing.assert_array_equal(
            PF.prune(torch.as_tensor(w), method, 0.5, num_heads=H).numpy(), np.asarray(want))


def test_pruned_gradient_is_the_masked_gradient():
    w = _rng(6).standard_normal((8, 8)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(JF.prune(x, "sparse", 0.5) * 3.0))(jnp.asarray(w))
    t = torch.as_tensor(w).requires_grad_(True)
    (PF.prune(t, "sparse", 0.5) * 3.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


# ------------------------------------------------------------------ #
# compress_params on the stacked leaves

TECHNIQUES = {
    "wq_sym_g4": _group("weight_quantization", {"start_bits": 8, "target_bits": 8},
                        quantize_groups=4),
    "wq_asym_attn": _group("weight_quantization", {"start_bits": 4}, ["attn"],
                           quantization_type="asymmetric"),
    "sparse_mlp": _group("sparse_pruning", {"dense_ratio": 0.3}, ["mlp"]),
    "row_w_up": _group("row_pruning", {"dense_ratio": 0.5}, ["w_up"]),
    "channel_all": _group("channel_pruning", {"dense_ratio": 0.6}),
    "head_embed": _group("head_pruning", {"dense_ratio": 0.5, "num_heads": 4},
                         ["embed.tokens"]),
}
TECHNIQUES["all"] = {"compression_training": {
    k: v for t in ("wq_sym_g4", "sparse_mlp", "row_w_up") for k, v in
    TECHNIQUES[t]["compression_training"].items()}}


@pytest.mark.parametrize("name", sorted(TECHNIQUES))
def test_compress_params_causal_lm_bit_equal(name):
    cfg = TECHNIQUES[name]
    jm, jp, pm, pp = _pair()
    want = JC.init_compression(jm, cfg).compress_params(jax.tree.map(jnp.asarray, jp))
    got = PC.init_compression(pm, cfg).compress_params(pp)
    _equal(params_to_jax(pm.config, got), want)
    changed = [not np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(jax.tree.map(np.asarray, want)), jax.tree.leaves(jp))]
    assert any(changed)


def test_per_layer_transform_is_another_model():
    """The same rules applied to each port leaf on its own (its own
    threshold, the biases skipped as rank 1) miss the JAX result."""
    cfg = {"compression_training": {
        **_group("sparse_pruning", {"dense_ratio": 0.3}, ["mlp"])["compression_training"],
        **_group("weight_quantization", {"start_bits": 4}, ["mlp"])["compression_training"]}}
    jm, jp, pm, pp = _pair()
    want = JC.init_compression(jm, cfg).compress_params(jax.tree.map(jnp.asarray, jp))
    naive = {n: PF.prune(PF.fake_quantize(t, 4), "sparse", 0.3)
             if ".mlp." in n and t.dim() >= 2 else t for n, t in pp.named_parameters()}
    from deepspeed_tpu_torch.compression.compress import _rebuild
    got = params_to_jax(pm.config, _rebuild(pp, naive))
    assert not np.array_equal(got["layers"]["mlp"]["w_up"], np.asarray(want["layers"]["mlp"]["w_up"]))
    assert not np.array_equal(got["layers"]["mlp"]["b_up"], np.asarray(want["layers"]["mlp"]["b_up"]))


@pytest.mark.parametrize("name", ["wq_sym_g4", "sparse_mlp", "all"])
def test_compress_params_bert_bit_equal(name):
    jm, jp, pm, pp = _bert_pair()
    cfg = TECHNIQUES[name]
    want = JC.init_compression(jm, cfg).compress_params(jax.tree.map(jnp.asarray, jp))
    got = PC.init_compression(pm, cfg).compress_params(pp)
    _equal(params_to_jax(pm.config, got), want)


def test_head_pruning_on_a_stacked_leaf_raises_in_both():
    """head_mask reads w.shape[0] (the layer count of a stacked leaf) as
    H * Hd: 3 layers and 4 heads divide by zero in both packages."""
    cfg = _group("head_pruning", {"dense_ratio": 0.5, "num_heads": 4}, ["attn.wo"])
    jm, jp, pm, pp = _pair()
    with pytest.raises(ZeroDivisionError):
        JC.init_compression(jm, cfg).compress_params(jax.tree.map(jnp.asarray, jp))
    with pytest.raises(ZeroDivisionError):
        PC.init_compression(pm, cfg).compress_params(pp)


def test_compressed_loss_and_grads_match_jax():
    cfg = TECHNIQUES["all"]
    jm, jp, pm, pp = _pair()
    batch = {"input_ids": _rng(7).integers(0, 64, (2, 16)).astype(np.int32)}
    jw = JC.init_compression(jm, cfg)
    jloss, jgrads = jax.value_and_grad(jw.loss)(jax.tree.map(jnp.asarray, jp), batch)
    pw = PC.init_compression(pm, cfg)
    for p in pp.parameters():
        p.requires_grad_(True)
    loss = pw.loss(pp, {"input_ids": torch.as_tensor(batch["input_ids"])})
    names = [n for n, _ in pp.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(pp.parameters()))))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = dict(params_from_jax(pm.config, jax.tree.map(np.asarray, jgrads)).named_parameters())
    for n, g in grads.items():
        w = want[n].detach()
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, n
    # the mlp's pruned entries take no gradient
    w_up = pp["layers"][0]["mlp"]["w_up"]
    stack = jnp.asarray(np.stack([lp["mlp"]["w_up"].detach().numpy() for lp in pp["layers"]]))
    mask = np.asarray(JF.sparse_mask(JF.fake_quantize(stack, 8, True, 4), 0.3))[0]
    assert 0 < (mask == 0).mean() < 1
    assert (grads["layers.0.mlp.w_up"].numpy()[mask == 0] == 0).all() and w_up.shape == mask.shape


def test_redundancy_clean_bit_equal():
    cfg = TECHNIQUES["all"]
    jm, jp, pm, pp = _pair()
    want = JC.redundancy_clean(jax.tree.map(jnp.asarray, jp), cfg)
    got = PC.redundancy_clean(pp, cfg)
    assert isinstance(got, type(pp))
    _equal(params_to_jax(pm.config, got), want)
    np.testing.assert_array_equal(got["ln_f"]["scale"].numpy(), jp["ln_f"]["scale"])  # rank 1
    with pytest.raises(ValueError, match="param tree"):
        PC.redundancy_clean(PC.init_compression(pm, cfg), cfg)
    # the cleaned tree serves: the engine's forward equals the compressed model's
    eng = deepspeed_tpu_torch.init_inference(pm, params=got, dtype="fp32", device="cpu")
    ids = _rng(8).integers(0, 64, (2, 10))
    np.testing.assert_array_equal(
        eng.forward(ids).numpy(),
        PC.init_compression(pm, cfg).forward(pp, torch.as_tensor(ids)).detach().numpy())


# ------------------------------------------------------------------ #
# the scheduler (TestCompressedTraining's gate, schedule_offset_end)

def test_scheduler_active_set_matches_jax():
    cfg = {"compression_training": {
        "weight_quantization": {"shared_parameters": {"enabled": True, "schedule_offset": 2,
                                                      "schedule_offset_end": 4},
                                "different_groups": {"wq": {"params": {"start_bits": 8},
                                                            "modules": ["mlp"]}}},
        "sparse_pruning": {"shared_parameters": {"enabled": True, "schedule_offset": 3},
                           "different_groups": {"sp": {"params": {"dense_ratio": 0.5}}}},
        "activation_quantization": {"shared_parameters": {"enabled": True,
                                                          "schedule_offset": 1},
                                    "different_groups": {"aq": {"params": {"bits": 8}}}}}}
    jm, _, pm, _ = _pair()
    jw, pw = JC.init_compression(jm, cfg), PC.init_compression(pm, cfg)
    js, ps = JC.CompressionScheduler(jw), PC.CompressionScheduler(pw)
    for step in range(7):
        assert [jw._active[id(r)] for r in jw.rules] == [pw._active[id(r)] for r in pw.rules]
        assert [r.technique for r in jw.rules] == [r.technique for r in pw.rules]
        assert [r.params for r in jw.rules] == [r.params for r in pw.rules]
        assert pw.model.config.act_quant_bits == jw.model.config.act_quant_bits
        assert pw.compression_epoch == jw.compression_epoch, step
        js.step()
        ps.step()
    assert ps.state_dict() == js.state_dict() == {"training_steps": 7}
    with pytest.raises(TypeError, match="init_compression"):
        PC.CompressionScheduler(pm)


def test_get_compression_config_matches_jax():
    cfg = {"compression_training": {
        "weight_quantization": {"shared_parameters": {"enabled": True,
                                                      "fp16_mixed_quantize": {"enabled": True}},
                                "different_groups": {"g": {"params": {"start_bits": 6}}}},
        "layer_reduction": {"enabled": True, "keep_number_layer": 2}}}
    assert PC.get_compression_config(cfg) == JC.get_compression_config(cfg)
    assert PC.get_compression_config({}) == JC.get_compression_config({})


# ------------------------------------------------------------------ #
# layer reduction (TestLayerReductionStudentInit)

LR_CFG = {"compression_training": {
    "layer_reduction": {"enabled": True, "keep_number_layer": 2, "teacher_layer": [1, 3],
                        "other_module_name": ["embed", "ln_f"]}}}


def test_layer_reduction_and_student_initialization_bit_equal():
    jt, jtp, pt, ptp = _pair(n_layer=4)
    js_, jsp, ps_, psp = _pair(n_layer=2)
    jw, pw = JC.init_compression(jt, LR_CFG), PC.init_compression(pt, LR_CFG)
    assert pw.model.config.n_layer == jw.model.config.n_layer == 2
    assert pt.config.n_layer == 4
    want = JC.student_initialization(jax.tree.map(jnp.asarray, jsp),
                                     jax.tree.map(jnp.asarray, jtp), LR_CFG)
    got = PC.student_initialization(psp, ptp, LR_CFG)
    _equal(params_to_jax(ps_.config, got), want)
    # copies: training the student leaves the teacher as it was
    got["embed"]["tokens"].data.add_(1.0)
    np.testing.assert_array_equal(ptp["embed"]["tokens"].numpy(), jtp["embed"]["tokens"])
    batch = {"input_ids": torch.as_tensor(_rng(9).integers(0, 64, (2, 16)))}
    assert np.isfinite(float(ps_.loss(got, batch)))


@pytest.mark.parametrize("case", ["count", "missing_other", "disabled"])
def test_student_initialization_errors_match_jax(case):
    _, jtp, _, ptp = _pair(n_layer=4)
    _, jsp, _, psp = _pair(n_layer=2)
    cfg = {"count": {"compression_training": {"layer_reduction": {
        "enabled": True, "teacher_layer": [0, 1, 2]}}},
        "missing_other": {"compression_training": {"layer_reduction": {
            "enabled": True, "teacher_layer": [0, 1], "other_module_name": ["pooler"]}}},
        "disabled": {}}[case]
    with pytest.raises(Exception) as je:
        JC.student_initialization(jsp, jtp, cfg)
    with pytest.raises(type(je.value)) as pe:
        PC.student_initialization(psp, ptp, cfg)
    assert str(pe.value) == str(je.value)


def test_bert_layer_reduction_rebuilds_zoo_cfg():
    cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [1, 3]}}}
    model = BertModel(BertConfig(vocab_size=64, n_layer=4, n_head=2, d_model=32, d_ff=64,
                                 max_seq=16))
    wrapped = PC.init_compression(model, cfg)
    assert wrapped.model.config.n_layer == 2
    assert wrapped.model.zoo_cfg.n_layer == 2       # derived config rebuilt
    assert wrapped.model._zoo_over == {}
    assert model.zoo_cfg.n_layer == 4               # caller untouched
    assert len(wrapped.model.init_params()["layers"]) == 2


# ------------------------------------------------------------------ #
# activation fake-quant (TestActivationQuantization, TestActQuantScheduling)

AQ_CFG = {"compression_training": {"activation_quantization": {
    "shared_parameters": {"enabled": True, "quantization_type": "symmetric",
                          "range_calibration": "dynamic", "schedule_offset": 0},
    "different_groups": {"aq1": {"params": {"bits": 8}, "modules": ["*"]}}}}}


@pytest.mark.parametrize("shape", ["gpt2", "llama"])
def test_act_quant_loss_and_grads_match_jax(shape):
    over = {} if shape == "gpt2" else dict(pos_embedding="rope", norm="rmsnorm",
                                           activation="swiglu", attn_bias=False, n_kv_head=1,
                                           tie_embeddings=False)
    jm, jp, pm, pp = _pair(n_layer=2, **over)
    jw, pw = JC.init_compression(jm, AQ_CFG), PC.init_compression(pm, AQ_CFG)
    assert pw.model.config.act_quant_bits == 8 and pm.config.act_quant_bits == 0
    batch = {"input_ids": _rng(10).integers(0, 64, (2, 16)).astype(np.int32)}
    jloss, jgrads = jax.value_and_grad(jw.loss)(jax.tree.map(jnp.asarray, jp), batch)
    for p in pp.parameters():
        p.requires_grad_(True)
    loss = pw.loss(pp, {"input_ids": torch.as_tensor(batch["input_ids"])})
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    plain = CausalLM(pm.config).loss(pp, {"input_ids": torch.as_tensor(batch["input_ids"])})
    assert float(plain.detach()) != float(loss.detach())                       # the fake-quant is in the loss
    grads = torch.autograd.grad(loss, list(pp.parameters()))
    want = dict(params_from_jax(pm.config, jax.tree.map(np.asarray, jgrads)).named_parameters())
    for (n, _), g in zip(pp.named_parameters(), grads):
        assert torch.isfinite(g).all(), n
        scale = max(float(want[n].abs().max()), 1e-6)
        assert float((g - want[n].detach()).abs().max()) <= GRAD_TOL * scale, n


def test_act_quant_refusals_match_jax():
    class Opaque:
        def loss(self, params, batch):
            return 0.0
    for model in (Opaque(), BertModel(BertConfig(**BERT), with_mlm_head=True)):
        with pytest.raises(ValueError, match="TransformerConfig"):
            PC.init_compression(model, AQ_CFG)
    with pytest.raises(ValueError, match="TransformerConfig"):
        JC.init_compression(JaxBertModel(JaxBertConfig(**BERT), with_mlm_head=True), AQ_CFG)
    jm, _, pm, _ = _pair()
    mixed = {"compression_training": {"activation_quantization": {
        "shared_parameters": {"enabled": True},
        "different_groups": {"a": {"params": {"bits": 8}}, "b": {"params": {"bits": 4}}}}}}
    bad_lr = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [0, 1, 2]}}}
    for cfg, match in ((mixed, "bit width"), (bad_lr, "inconsistent")):
        with pytest.raises(ValueError, match=match):
            JC.init_compression(jm, cfg)
        with pytest.raises(ValueError, match=match):
            PC.init_compression(pm, cfg)


@pytest.mark.parametrize("bits", [8, 4])
def test_act_quant_decode_matches_forward(bits):
    """QAT train / deploy parity: the cached path and the paged prefill of a
    whole sequence quantize the same inputs as forward(), so their logits
    match the JAX forward's; a one-token decode step (its own per-tensor
    range), cached and paged, matches the JAX cached decode step. Within
    DECODE_TOL, a tenth of what leaving the fake-quant out moves them."""
    kw = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=16, remat=False,
              act_quant_bits=bits)
    jm = JaxCausalLM(JT.TransformerConfig(attention_backend="xla", **kw))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    jparams = jax.tree.map(jnp.asarray, jp)
    toks = np.asarray([[5, 9, 2, 7, 1, 3]], np.int32)
    full = np.asarray(jm.forward(jparams, jnp.asarray(toks)), np.float32)
    plain = np.asarray(JaxCausalLM(JT.TransformerConfig(
        attention_backend="xla", **{**kw, "act_quant_bits": 0})).forward(jparams,
                                                                         jnp.asarray(toks)))
    assert np.abs(plain - full).max() > 10 * DECODE_TOL        # the fake-quant moves the logits
    jcache = jm.init_cache(1, 16, dtype=jnp.float32)
    _, jcache = jm.forward_cached(jparams, jnp.asarray(toks[:, :5]), jcache, jnp.int32(0))
    jstep, _ = jm.forward_cached(jparams, jnp.asarray(toks[:, 5:]), jcache, jnp.int32(5))
    jstep = np.asarray(jstep, np.float32)[:, 0]
    close = lambda got, want: np.testing.assert_allclose(got.numpy(), want, rtol=DECODE_TOL,
                                                         atol=DECODE_TOL)
    for backend in ("xla", "flash"):
        pm = CausalLM(TransformerConfig(attention_backend=backend, **kw))
        pp = params_from_jax(pm.config, jp)
        with torch.no_grad():
            close(pm.forward(pp, torch.as_tensor(toks)), full)
            cache = pm.init_cache(1, 16, dtype=torch.float32)
            close(pm.forward_cached(pp, torch.as_tensor(toks), cache, 0)[0], full)
            cache = pm.init_cache(1, 16, dtype=torch.float32)
            pm.forward_cached(pp, torch.as_tensor(toks[:, :5]), cache, 0)
            close(pm.forward_cached(pp, torch.as_tensor(toks[:, 5:]), cache, 5)[0][:, 0], jstep)
            # paged: the whole sequence prefilled into blocks of 4; then 5
            # prefilled and the sixth decoded
            pools = pm.init_paged_cache(5, 4, dtype=torch.float32)
            last, _ = pm.forward_paged_prefill(pp, torch.as_tensor(toks), pools,
                                               torch.arange(8, 14), 5)
            close(last, full[:, 5])
            pools = pm.init_paged_cache(5, 4, dtype=torch.float32)
            pm.forward_paged_prefill(pp, torch.as_tensor(toks[:, :5]), pools,
                                     torch.arange(8, 13), 4)
            bt = torch.tensor([[2, 3, 0, 0]], dtype=torch.int32)
            dec, _ = pm.forward_paged_decode(pp, torch.as_tensor(toks[:, 5:]), pools, bt,
                                             torch.tensor([5], dtype=torch.int32))
            close(dec, jstep)


def test_act_quant_model_serves_through_the_engines():
    """init_inference of a QAT model: the static generate and the paged
    generate_batch give the tokens of a greedy loop over forward()."""
    kw = dict(GPT2, n_layer=2, act_quant_bits=8, attention_backend="flash")
    pm = CausalLM(TransformerConfig(**kw))
    pp = pm.init_params(torch.Generator().manual_seed(0))
    eng = deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu")
    prompt = [3, 17, 5, 40, 2]
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(4):
            ids.append(int(pm.forward(pp, torch.as_tensor([ids]))[0, -1].argmax()))
    static = eng.generate(np.asarray([prompt]), max_new_tokens=4)
    assert [int(t) for t in np.asarray(static)[0, -4:]] == ids[-4:]
    paged = eng.generate_batch([prompt], max_new_tokens=4)
    assert [int(t) for t in paged[0][-4:]] == ids[-4:]


# ------------------------------------------------------------------ #
# the engine across a schedule transition

def _engine_config(**over):
    return {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "steps_per_print": 0,
            **over}


def test_engine_trains_across_the_act_quant_transition_like_jax():
    """A CompressedModel (weight quant from step 0, act quant from step 2)
    through initialize + CompressionScheduler: losses against the JAX
    engine's on a one-device mesh, step by step; the transition fires at
    its offset."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    cfg = {"compression_training": {
        **TECHNIQUES["wq_sym_g4"]["compression_training"],
        "activation_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 2},
            "different_groups": {"aq1": {"params": {"bits": 4}}}}}}
    jm, jp, pm, pp = _pair(n_layer=2)
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    try:
        jw = JC.init_compression(jm, cfg)
        js = JC.CompressionScheduler(jw)
        jeng, _, _, _ = deepspeed_tpu.initialize(model=jw, model_parameters=jp,
                                                 config=_engine_config())
        pw = PC.init_compression(pm, cfg)
        ps = PC.CompressionScheduler(pw)
        peng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=pw, model_parameters=params_from_jax(pm.config, jp), config=_engine_config(),
            device="cpu")
        batch = {"input_ids": _rng(11).integers(0, 64, (2, 16)).astype(np.int32)}
        bits = []
        for step in range(4):
            jl = float(jeng.train_batch(batch))
            pl = float(peng.train_batch(batch))
            assert abs(pl - jl) <= 1e-4 * abs(jl), (step, pl, jl)
            bits.append(pw.model.config.act_quant_bits)
            assert bits[-1] == jw.model.config.act_quant_bits
            js.step()
            ps.step()
        assert bits == [0, 0, 4, 4]
    finally:
        jdist.set_mesh(saved)


def test_engine_config_reaches_both_variants():
    """The JSON fused_cross_entropy reaches the plain and the act-quant
    variant, so the fused CE head (K3 on the card) runs after the
    transition as before it."""
    cfg = {"compression_training": {"activation_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 1},
        "different_groups": {"aq1": {"params": {"bits": 8}}}}}}
    pm = CausalLM(TransformerConfig(**dict(GPT2, n_layer=1)))
    pw = PC.init_compression(pm, cfg)
    ps = PC.CompressionScheduler(pw)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=pw, config=_engine_config(fused_cross_entropy="on"), device="cpu")
    from deepspeed_tpu_torch.models import transformer as PT
    seen = []
    real = PT.fused_cross_entropy
    PT.fused_cross_entropy = lambda *a, **k: (seen.append(1), real(*a, **k))[1]
    try:
        batch = {"input_ids": _rng(12).integers(0, 64, (2, 16))}
        for _ in range(3):
            eng.train_batch(batch)
            ps.step()
    finally:
        PT.fused_cross_entropy = real
    assert seen == [1, 1, 1]
    assert pw._plain_model.config.fused_cross_entropy == "on"
    assert pw._act_model.config.fused_cross_entropy == "on"
    assert pw.model is pw._act_model and pw.model.config.act_quant_bits == 8
    assert pm.config.fused_cross_entropy == "auto"              # the caller's model untouched
    assert copy.copy(pw).rules is pw.rules
