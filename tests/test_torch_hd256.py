"""Head dim 256 (GPT-J's heads) on the port's serving paths: a tiny
GPT-J-shaped model (2 layers, 2 heads x 256, rotary_dim 64 with interleaved
pairs, parallel residual, untied head with its bias) with
``attention_backend="flash"``, the port on the CPU (kernels A, B and K5 take
their plain versions at Hd 256) against the JAX engine on a one-device mesh
(its Pallas kernels in interpret mode), same weights (``params_from_jax``),
fp32: forward logits within ``TOL``, paged ``generate_batch`` and static
``generate`` tokens equal wherever the JAX model's top-2 logit margin
exceeds ``MARGIN`` (the rule of ``tests/test_torch_serving.py``). Training
through a head past 128 runs (kernels C and D take 256)."""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

MARGIN = 1e-3       # tests/test_torch_serving.py
TOL = 1e-4          # fp32 logits, absolute (tests/test_torch_model.py)
GPTJ = dict(vocab_size=64, max_seq=256, n_layer=2, n_head=2, d_model=512, d_ff=256,
            pos_embedding="rope", rope_dim=64, rope_interleaved=True, norm="layernorm",
            activation="gelu", parallel_residual=True, tie_embeddings=False,
            attn_bias=False, lm_head_bias=True, attention_backend="flash")
SERVING = {"block_size": 128, "max_running": 2}


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX engine, so its dispatch takes the bare
    Pallas kernels (interpret mode) as on one chip. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    jdist.set_mesh(saved)


@pytest.fixture(scope="module")
def pair(one_device_mesh):
    jmodel = JaxCausalLM(JT.TransformerConfig(remat=False, **GPTJ))
    jparams = jax.tree.map(np.asarray, JT.init_params(jmodel.config, jax.random.key(3)))
    # a nonzero head bias, so the bias is seen
    jparams["lm_head_bias"] = np.random.default_rng(3).normal(
        size=GPTJ["vocab_size"]).astype(np.float32) * 0.1
    pmodel = CausalLM(TransformerConfig(**GPTJ))
    assert pmodel.config.head_dim == 256
    params = params_from_jax(pmodel.config, jparams)
    jeng = deepspeed_tpu.init_inference(jmodel, params=jparams, dtype="fp32", serving=SERVING)
    peng = deepspeed_tpu_torch.init_inference(pmodel, params=params, dtype="fp32",
                                              device="cpu", serving=SERVING)
    return jmodel, jparams, jeng, peng


def _check_tokens(jmodel, jparams, prompts, got, want):
    """Equal, or first differing where the JAX margin is a near-tie."""
    compared = 0
    for p, g, w in zip(prompts, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            compared += g.size - p.size
            continue
        i = int(diff[0])
        logits = np.asarray(jmodel.forward(jparams, w[None, :i]))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < MARGIN, (
            f"tokens differ at {i} where the JAX margin is {top2[1] - top2[0]}")
        compared += i - p.size
    return compared


def _prompts(seed, lengths):
    r = np.random.default_rng(seed)
    return [r.integers(0, GPTJ["vocab_size"], size=n).astype(np.int32) for n in lengths]


def test_forward_logits_match_jax(pair):
    jmodel, jparams, jeng, peng = pair
    tok = np.random.default_rng(0).integers(0, GPTJ["vocab_size"], size=(2, 40)).astype(np.int32)
    want = np.asarray(jeng.forward(tok), np.float32)
    got = peng.forward(tok).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_paged_serve_matches_jax(pair):
    """Prefill through A and decode through B, both at Hd 256."""
    jmodel, jparams, jeng, peng = pair
    n0 = fa.launches
    prompts = _prompts(1, (7, 60, 140))
    want = jeng.generate_batch(prompts, max_new_tokens=8)
    got = peng.generate_batch(prompts, max_new_tokens=8)
    assert _check_tokens(jmodel, jparams, prompts, got, want) > 0
    assert peng._last_serve_actions.get("prefill") == 3 and \
        peng._last_serve_actions.get("decode", 0) > 0
    assert fa.launches == n0       # the CPU takes the plain versions: no kernel launch
    assert jeng._last_serve_stats == peng._last_serve_stats


def test_static_generate_matches_jax(pair):
    """Static generate: A over the prompt bucket, then the dense decode (K5)."""
    jmodel, jparams, jeng, peng = pair
    ids = np.stack(_prompts(2, (20, 20)))
    want = np.asarray(jeng.generate(ids, max_new_tokens=8))
    got = np.asarray(peng.generate(ids, max_new_tokens=8))
    assert _check_tokens(jmodel, jparams, list(ids), got, want) > 0


def test_training_past_head_dim_128_names_its_queue_item():
    """Training through a head past 128 runs (kernels C and D take 256; on
    the CPU their plain versions): a finite loss from the engine, and the
    autograd Function's gradients at Hd 256 finite, A alone without one."""
    model = CausalLM(TransformerConfig(**{**GPTJ, "d_ff": 128}))
    config = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "fused_cross_entropy": "off"}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    batch = {"input_ids": np.random.default_rng(0).integers(0, 64, size=(2, 16))
             .astype(np.int32)}
    assert np.isfinite(float(engine.train_batch(batch)))
    q = torch.randn(1, 16, 2, 256, requires_grad=True)
    (g,) = torch.autograd.grad(fa.flash_attention(q, q, q).square().sum(), q)
    assert g.shape == q.shape and torch.isfinite(g).all()
    with torch.no_grad():
        assert fa.flash_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("hd,kernel", [(136, 256), (200, 256), (256, 256), (128, 128),
                                       (96, 128), (40, 64)])
def test_kernel_head_dim_pads_to_the_next_instantiation(hd, kernel):
    assert fa.kernel_head_dim(hd) == kernel
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        fa.kernel_head_dim(264)
