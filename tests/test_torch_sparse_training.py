"""The sparse train path end to end on the CPU: a tiny Llama (2 layers,
d_model 128, 4 heads, S 256) with block-sparse attention, the same weights
carried across by ``params_from_jax``, against the JAX package. Logits of
the full forward agree within 1e-4 under ``attention_backend`` "flash" (the
JAX kernel in interpret mode at block 128, the port's plain layout-aware
versions) and "xla" (the dense token-bias form in both), at blocks 128 and
32; three ``train_batch`` steps at gas 2 through ``initialize`` give losses
within 1e-5 (relative) of the JAX engine's, as ``tests/test_torch_training.py``
holds the dense path. Also: the ``sparse_attention`` config section is kept
as the JAX package keeps it, and the settings sparse attention refuses are
refused with the JAX package's messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.core import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.config.core import DeepSpeedConfig
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import sparse_attention as psa

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5     # relative, per step
S = 256
LLAMA = dict(vocab_size=256, max_seq=S, n_layer=2, n_head=4, d_model=128, d_ff=256,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             norm_eps=1e-6)
# block -> (config class, keyword arguments): at block 128 each 128-token
# half attends itself only (the kernel path); at block 32 a Fixed layout
# (the dense token-bias form in both packages, as the kernels want >= 128)
SPARSITY = {
    128: ("LocalSlidingWindowSparsityConfig", dict(num_heads=4, block=128,
                                                   num_sliding_window_blocks=1)),
    32: ("FixedSparsityConfig", dict(num_heads=4, block=32, num_local_blocks=4,
                                     attention="unidirectional")),
}


def _sparsity(pkg, block):
    cls, kw = SPARSITY[block]
    return getattr(pkg, cls)(**kw)


def _pair(block, backend, **over):
    kw = {**LLAMA, "attention_backend": backend, **over}
    jcfg = JT.TransformerConfig(**kw, sparse_attention=_sparsity(jsa, block))
    pcfg = TransformerConfig(**kw, sparse_attention=_sparsity(psa, block))
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(block)))
    return jcfg, pcfg, tree


@pytest.mark.parametrize("backend", ["flash", "xla"])
@pytest.mark.parametrize("block", sorted(SPARSITY))
def test_sparse_logits_match_jax(block, backend):
    jcfg, pcfg, tree = _pair(block, backend)
    tokens = np.random.default_rng(block).integers(0, LLAMA["vocab_size"], size=(2, S))
    want = JT.forward(jcfg, tree, jnp.asarray(tokens))
    got = PT.forward(pcfg, params_from_jax(pcfg, tree), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
    dense = PT.forward(TransformerConfig(**{**LLAMA, "attention_backend": backend}),
                       params_from_jax(pcfg, tree), torch.from_numpy(tokens))
    assert float((dense - got).abs().max()) > 100 * LOGIT_TOL     # the layout drops pairs


def _config():
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedAdam",
                          "params": {"lr": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8,
                                     "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4,
                                     "warmup_num_steps": 2}},
            "gradient_clipping": 1.0, "fused_cross_entropy": "off",
            "sparse_attention": {"mode": "fixed", "block": 32, "num_local_blocks": 4}}


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX engine, so its dispatch takes the bare
    Pallas kernels (interpret mode) as on one chip. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


@pytest.mark.parametrize("block", sorted(SPARSITY))
def test_sparse_engine_matches_jax_engine(one_device_mesh, block):
    jcfg, pcfg, tree = _pair(block, "flash")
    config = _config()
    jeng, _, _, _ = deepspeed_tpu.initialize(model=JaxCausalLM(jcfg), model_parameters=tree,
                                             config=config, mesh=one_device_mesh)
    model = CausalLM(pcfg)
    peng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(pcfg, tree), config=config, device="cpu")
    r = np.random.default_rng(7)
    for step in range(3):
        batch = {"input_ids": r.integers(0, LLAMA["vocab_size"], size=(4, S)).astype(np.int32)}
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
    assert peng.global_steps == 3


def test_sparse_attention_section_is_kept_as_jax_keeps_it():
    section = {"mode": "bigbird", "block": 64, "num_random_blocks": 2}
    cfg = {"train_micro_batch_size_per_gpu": 1, "sparse_attention": section}
    assert DeepSpeedConfig(cfg).sparse_attention == JaxConfig(cfg).sparse_attention == section
    assert DeepSpeedConfig({"train_batch_size": 2}).sparse_attention is None


@pytest.mark.parametrize("over,sparsity,err,match", [
    (dict(n_kv_head=2), None, NotImplementedError, "n_kv_head == n_head"),
    (dict(pos_embedding="alibi"), None, NotImplementedError, "alibi"),
    (dict(causal=False), None, ValueError, "disagrees"),
    ({}, dict(num_heads=2), ValueError, "num_heads=2 != model n_head=4"),
])
def test_sparse_refusals_match_jax(over, sparsity, err, match):
    kw = dict(SPARSITY[32][1], **(sparsity or {}))
    jcfg = JT.TransformerConfig(**{**LLAMA, **over},
                                sparse_attention=jsa.FixedSparsityConfig(**kw))
    pcfg = TransformerConfig(**{**LLAMA, **over}, sparse_attention=psa.FixedSparsityConfig(**kw))
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(0)))
    tokens = np.zeros((1, 64), np.int32)
    with pytest.raises(err, match=match):
        JT.forward(jcfg, tree, jnp.asarray(tokens))
    with pytest.raises(err, match=match):
        PT.forward(pcfg, params_from_jax(pcfg, tree), torch.from_numpy(tokens))


def test_sparse_is_refused_by_the_decode_paths_and_by_sequence_parallelism():
    jcfg, pcfg, tree = _pair(32, "flash")
    params = params_from_jax(pcfg, tree)
    cache = PT.init_kv_cache(pcfg, 1, S)
    with pytest.raises(NotImplementedError, match="KV-cache decode path"):
        PT.forward_cached(pcfg, params, torch.zeros((1, 4), dtype=torch.long), cache, 0)
    with pytest.raises(NotImplementedError, match="paged KV decode path"):
        PT.forward_paged_decode(pcfg, params, torch.zeros((1, 1), dtype=torch.long),
                                PT.init_paged_kv_cache(pcfg, 2, 128),
                                torch.zeros((1, 1), dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32))
    sp = TransformerConfig(**LLAMA, sequence_parallel="ring",
                           sparse_attention=_sparsity(psa, 32))
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        PT.forward(sp, params, torch.zeros((1, 64), dtype=torch.long))


def test_the_sparse_layout_is_built_and_read_once_per_config_and_length(monkeypatch):
    """Two forward + backward passes of a 2-layer sparse model with full
    remat (each block's forward recomputed in the backward): the sparsity
    config's ``make_layout`` runs once for (config, S); every forward, dq
    and dk/dv call of every layer gets the same layout object, so the
    kernels' ``_device_layout`` (the CUDA path's cache of live-tile lists,
    fed here each call's layout) reads the layout's content once and takes
    its identity path after."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    _, pcfg, tree = _pair(128, "flash", remat=True)
    sc = pcfg.sparse_attention
    made, calls = [], []
    make_layout, dispatch = type(sc).make_layout, fa._dispatch
    monkeypatch.setattr(type(sc), "make_layout",
                        lambda self, seq: made.append(seq) or make_layout(self, seq))

    def spy(cuda_fn, plain_fn, name, q, *args):
        calls.append((name, args[-1], q.shape[1], q.shape[2]))
        return dispatch(cuda_fn, plain_fn, name, q, *args)
    monkeypatch.setattr(fa, "_dispatch", spy)
    PT._sparse_layout.cache_clear()
    params = params_from_jax(pcfg, tree).map(lambda t: t.clone(), requires_grad=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, LLAMA["vocab_size"],
                                                                size=(2, S)))
    for _ in range(2):
        PT.lm_loss(pcfg, params, {"input_ids": tokens}).backward()
    assert made == [S]
    # 2 passes x 2 layers x (forward, its remat recompute, dq, dkv)
    assert len(calls) == 16 and {c[0] for c in calls} == {
        "flash_attention", "flash_attention_dq", "flash_attention_dkv"}
    assert all(c[1] is calls[0][1] for c in calls)
    read = []
    layout_keep = fa._layout_keep
    monkeypatch.setattr(fa, "_layout_keep", lambda *a: read.append(a[1]) or layout_keep(*a))
    fa._LAST.clear()
    for _, layout, seq, heads in calls:
        fa._device_layout(layout, seq, heads, True, torch.device("cpu"))
    assert read == [S]
