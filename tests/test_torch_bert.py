"""The port's BERT (``deepspeed_tpu_torch/models/bert.py``) against the JAX
package's ``BertModel`` on the same weights (``params_from_jax``): a tiny
post-LN encoder (2 layers, d 64, 4 heads, vocab 128, S 32, fp32).

Hidden states, the pooled output and the MLM logits, with and without an
attention mask, within ``TOL``; the MLM loss unchunked, with ``loss_chunk``
and through the masked-position gather (within its budget, and past it:
the overflow dropped as in the JAX package and one warning); dropout drawn
only when a generator is given; the parameter and FLOP counts; the
inference engine's forward (MLM logits, or hidden states headless) and its
refusal to generate; a headless loss refused; three AdamW steps through
``initialize`` against the JAX engine; the JSON ``fused_cross_entropy``
pushed into both configs; the tree across ``params_from_jax`` /
``params_to_jax`` bit for bit; and a block-sparse BERT
(``replace_self_attention``) against the JAX one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.bert import BertConfig as JaxBertConfig
from deepspeed_tpu.models.bert import BertModel as JaxBertModel
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import BertConfig, BertModel

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TOL = 1e-5                 # fp32 outputs and losses (rtol and atol)
LOSS_TOL = 1e-5            # engine losses, relative
RTOL, ATOL = 2e-4, 2e-5    # params after the engine steps (tests/unit/test_offload.py)
SMALL = dict(vocab_size=128, max_seq=64, n_layer=2, n_head=4, d_model=64, d_ff=128,
             remat=False)
B, S = 2, 32


def _pair(head=True, seed=0, **over):
    jm = JaxBertModel(JaxBertConfig(**SMALL, **over), with_mlm_head=head)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    pm = BertModel(BertConfig(**SMALL, **over), with_mlm_head=head)
    return jm, jp, pm, params_from_jax(pm.config, jp)


def _inputs(seed=1, masked_share=0.15):
    r = np.random.default_rng(seed)
    ids = r.integers(5, 128, size=(B, S)).astype(np.int32)
    lengths = np.array([S, 19])
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    types = (np.arange(S)[None] >= 11).astype(np.int32).repeat(B, 0)
    labels = np.where((r.random((B, S)) < masked_share) & (mask > 0), ids, -100).astype(np.int32)
    return ids, mask, types, labels


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_hidden_pooled_and_mlm_logits_match_jax(masked):
    jm, jp, pm, pp = _pair()
    ids, mask, types, _ = _inputs()
    m = mask if masked else None
    h, pooled = pm(pp, torch.as_tensor(ids), torch.as_tensor(types),
                   None if m is None else torch.as_tensor(m))
    jh, jpooled = jm(jp, jnp.asarray(ids), jnp.asarray(types), None if m is None else jnp.asarray(m))
    _close(h, jh)
    _close(pooled, jpooled)
    _close(pm.mlm_logits(pp, ids, types, m), jm.mlm_logits(jp, ids, types, m))
    # forward: the MLM logits with the head, the hidden states without
    _close(pm.forward(pp, ids, m), jm.forward(jp, ids, m))
    hm, hjp, hpm, hpp = _pair(head=False)
    _close(hpm.forward(hpp, ids, m), hm.forward(hjp, ids, m))
    with pytest.raises(ValueError, match="no MLM head"):
        hpm.mlm_logits(hpp, ids)


@pytest.mark.parametrize("form", ["unchunked", "loss_chunk", "gather"])
def test_mlm_loss_matches_jax(form):
    over = {"unchunked": {}, "loss_chunk": {"loss_chunk": 16},
            "gather": {"mlm_gather_budget": 0.25}}[form]
    jm, jp, pm, pp = _pair(**over)
    ids, mask, types, labels = _inputs()
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask, "token_type_ids": types}
    assert int((labels != -100).sum()) <= round(0.25 * B * S)     # within the gather budget
    want = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = pm.loss(pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(got) - want) <= TOL * abs(want)
    # the gradient reaches every leaf the loss uses (the pooler's does not)
    for p in pp.parameters():
        p.requires_grad_(True)
    loss = pm.loss(pp, {k: torch.as_tensor(v) for k, v in batch.items()})
    names = [n for n, _ in pp.named_parameters()]
    grads = torch.autograd.grad(loss, list(pp.parameters()), allow_unused=True)
    missing = {n for n, g in zip(names, grads) if g is None}
    assert missing == {"pooler.w", "pooler.b"}
    jgrads = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, jp))
    jnamed = dict(params_from_jax(pm.config, jax.tree.map(np.asarray, jgrads)).named_parameters())
    # each leaf within 3e-5 of its largest value, floored at 1e-4 of the
    # largest gradient of all (bk's is zero but for rounding: the softmax
    # does not see a key bias)
    gmax = max(float(t.abs().max()) for t in jnamed.values())
    for n, g in zip(names, grads):
        if g is not None:
            want_g = jnamed[n].detach()
            scale = max(float(want_g.abs().max()), 1e-4 * gmax)
            assert float((g - want_g).abs().max()) <= 3e-5 * scale, n


def test_gather_budget_overflow_drops_like_jax_and_warns_once(monkeypatch):
    from deepspeed_tpu_torch.utils import logging as plog
    jm, jp, pm, pp = _pair(mlm_gather_budget=0.05)     # k = 3 of ~8 masked
    ids, mask, types, labels = _inputs()
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask}
    assert int((labels != -100).sum()) > 3
    warned = []
    plog.warn_once.cache_clear()
    monkeypatch.setattr(plog.logger, "warning", lambda msg, *a, **k: warned.append(msg))
    want = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    for _ in range(2):
        got = float(pm.loss(pp, {k: torch.as_tensor(v) for k, v in batch.items()}))
        assert abs(got - want) <= TOL * abs(want)
    assert len(warned) == 1 and "mlm_gather_budget=0.05 gathers 3" in warned[0]
    plog.warn_once.cache_clear()


def test_dropout_only_with_a_generator():
    jm, jp, pm, pp = _pair(dropout=0.1)
    ids, mask, _, labels = _inputs()
    batch = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels),
             "attention_mask": torch.as_tensor(mask)}
    want = float(jm.loss(jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}))
    plain = float(pm.loss(pp, batch))
    assert abs(plain - want) <= TOL * abs(want)          # no generator: no dropout
    drawn = [float(pm.loss(pp, batch, rng=torch.Generator().manual_seed(s))) for s in (7, 7, 8)]
    assert drawn[0] == drawn[1] != drawn[2] and drawn[0] != plain


@pytest.mark.parametrize("head,budget", [(True, 0.0), (True, 0.25), (False, 0.0)])
def test_parameter_and_flop_counts_match_jax(head, budget):
    jm, jp, pm, pp = _pair(head=head, mlm_gather_budget=budget)
    assert pm.num_parameters == jm.num_parameters == sum(p.numel() for p in pp.parameters())
    assert pm.flops_per_token(S) == jm.flops_per_token(S)
    assert pm.flops_per_token() == jm.flops_per_token()


def test_headless_loss_raises_like_jax():
    jm, jp, pm, pp = _pair(head=False)
    ids, _, _, labels = _inputs()
    with pytest.raises(ValueError, match="needs the MLM head") as err:
        pm.loss(pp, {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)})
    with pytest.raises(ValueError) as jerr:
        jm.loss(jp, {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)})
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("head", [True, False])
def test_inference_engine_forward_and_generation_refused(head):
    _, _, pm, pp = _pair(head=head)
    ids, mask, _, _ = _inputs()
    engine = deepspeed_tpu_torch.init_inference(pm, params=pp, dtype="fp32", device="cpu")
    for m in (None, mask):
        got = engine.forward(ids, attention_mask=m)
        want = pm.forward(pp, torch.as_tensor(ids), None if m is None else torch.as_tensor(m))
        assert torch.equal(got, want)
    # casting to the engine's dtype keeps BERT's extra keys
    names = {n for n, _ in engine.params.named_parameters()}
    assert {"embed.token_type", "embed.ln.scale", "pooler.w"} <= names
    assert ("mlm.decoder_bias" in names) == head
    with pytest.raises(ValueError, match="BertModel is an encoder"):
        engine.generate(ids[:1, :8], max_new_tokens=2)
    with pytest.raises(ValueError, match="BertModel is an encoder"):
        engine.generate_batch([list(ids[0, :8])], max_new_tokens=2)


@pytest.fixture
def one_device_mesh():
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def test_engine_steps_match_jax(one_device_mesh):
    """Three AdamW steps (clipping, gather budget 0.25) through
    ``initialize`` on the port's engine and on the JAX engine: each loss
    within LOSS_TOL relative, every param within RTOL / ATOL."""
    jm, jp, pm, pp = _pair(mlm_gather_budget=0.25)
    config = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=jax.tree.map(jnp.asarray, jp),
                                    config=config)[0]
    peng = deepspeed_tpu_torch.initialize(model=pm, model_parameters=pp, config=config,
                                          device="cpu")[0]
    ids, mask, types, labels = _inputs()
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask, "token_type_ids": types}
    losses = []
    for _ in range(3):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want)
        losses.append(got)
    assert losses[-1] < losses[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jeng.state.params))[0]
    got = jax.tree.leaves(params_to_jax(pm.config, peng.state.params))
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=jax.tree_util.keystr(path))


def test_json_fused_cross_entropy_refreshes_zoo_cfg():
    _, _, pm, pp = _pair()
    assert pm.zoo_cfg.fused_cross_entropy == "auto"
    config = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "fused_cross_entropy": "off"}
    engine = deepspeed_tpu_torch.initialize(model=pm, model_parameters=pp, config=config,
                                            device="cpu")[0]
    assert engine.module.config.fused_cross_entropy == "off"
    assert engine.module.zoo_cfg == dataclasses.replace(pm.config.zoo(),
                                                        fused_cross_entropy="off")
    # a sparse BERT keeps its sparsity through the push
    from deepspeed_tpu_torch.ops import sparse_attention as psa
    sc = psa.FixedSparsityConfig(num_heads=4, block=16, attention="bidirectional")
    sparse = psa.replace_self_attention(pm, sc)
    engine = deepspeed_tpu_torch.initialize(model=sparse, model_parameters=pp, config=config,
                                            device="cpu")[0]
    assert engine.module.zoo_cfg.sparse_attention is sc
    assert engine.module.zoo_cfg.fused_cross_entropy == "off"


def test_params_cross_between_the_packages_bit_for_bit():
    _, jp, pm, pp = _pair()
    back = params_to_jax(pm.config, pp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    assert {n for n, _ in pp.named_parameters()} >= {
        "embed.token_type", "embed.ln.scale", "embed.ln.bias", "pooler.w", "pooler.b",
        "mlm.w", "mlm.b", "mlm.ln.scale", "mlm.ln.bias", "mlm.decoder_bias",
        "layers.1.attn.wq"}


@pytest.mark.parametrize("kind", ["fixed", "bigbird"])
def test_sparse_bert_matches_jax(kind):
    """``replace_self_attention`` on the port's BertModel against the JAX
    package's on the same weights, at max_seq 64 with a padding mask
    (block 16: both take the dense token-bias form)."""
    from deepspeed_tpu.ops import sparse_attention as jsa
    from deepspeed_tpu_torch.ops import sparse_attention as psa
    jm, jp, pm, pp = _pair()
    make = {"fixed": lambda m: m.FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=2,
                                                     attention="bidirectional"),
            "bigbird": lambda m: m.BigBirdSparsityConfig(num_heads=4, block=16,
                                                         num_random_blocks=1)}[kind]
    js, ps = jsa.replace_self_attention(jm, make(jsa)), psa.replace_self_attention(pm, make(psa))
    r = np.random.default_rng(5)
    ids = r.integers(5, 128, size=(B, 64)).astype(np.int32)
    mask = (np.arange(64)[None] < np.array([64, 40])[:, None]).astype(np.int32)
    h, pooled = ps(pp, torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    jh, jpooled = js(jp, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    _close(h, jh)
    _close(pooled, jpooled)
    dense, _ = pm(pp, torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    assert float((dense - h).abs().max()) > 1e-3       # the layout is applied


def test_health_telemetry_and_a_tag_cross_into_the_jax_engine(one_device_mesh, tmp_path):
    """BERT's extra non-layer leaves (token types, the embedding LN, the
    pooler, the MLM head) through the engine's other passes: with health on,
    2 steps in both engines give the same bucket names and grad norms
    (within LOSS_TOL); the MFU numerator is the model's flops_per_token; a
    port tag loads into the JAX engine bit for bit (its JAX-layout state
    tree), and the next step's losses agree."""
    from deepspeed_tpu_torch.monitor.metrics import get_registry
    jm, jp, pm, pp = _pair(mlm_gather_budget=0.25)
    config = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0,
              "telemetry": {"health": {"enabled": True, "window": 4, "warmup_steps": 2}}}
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=jax.tree.map(jnp.asarray, jp),
                                    config=config, mesh=one_device_mesh)[0]
    peng = deepspeed_tpu_torch.initialize(model=pm, model_parameters=pp, config=config,
                                          device="cpu")[0]
    ids, mask, types, labels = _inputs()
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask, "token_type_ids": types}
    try:
        for _ in range(2):
            jeng.train_batch(batch)
            peng.train_batch(batch)
        assert peng._health.bucket_names == jeng._health.bucket_names
        for a, b in zip(peng._health.ring, jeng._health.ring):
            assert abs(a.grad_norm - b.grad_norm) <= LOSS_TOL * abs(b.grad_norm)
        assert peng._tel_flops_per_token(S) == pm.flops_per_token(S)
        peng.save_checkpoint(str(tmp_path), tag="p")
        jm2, jother, _, _ = _pair(mlm_gather_budget=0.25, seed=9)
        jeng2 = deepspeed_tpu.initialize(model=jm2, model_parameters=jax.tree.map(jnp.asarray,
                                                                                 jother),
                                         config={k: v for k, v in config.items()
                                                 if k != "telemetry"}, mesh=one_device_mesh)[0]
        jeng2.load_checkpoint(str(tmp_path), tag="p")
        want = jax.tree.leaves(params_to_jax(pm.config, peng.state.params))
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jeng2.state.params)), want):
            np.testing.assert_array_equal(a, b)
        w, g = float(jeng2.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(g - w) <= LOSS_TOL * abs(w)
    finally:
        peng.destroy()
        get_registry().reset()
