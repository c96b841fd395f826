"""Int8 weight-only inference in the port (``init_inference(...,
dtype="int8")``: the weight matrices rest as int8 payloads with fp32 group
scales, each matmul dequantizes its weight at use, activations and caches
run bf16) against the JAX engine's int8 path on a one-device mesh with
``attention_backend="flash"`` (its Pallas kernels in interpret mode), on a
2-layer tiny Llama-shaped model whose JAX weights cross with
``params_from_jax``.

Forward logits per position within ``LOGIT_ULPS`` bf16 ulps of the row's
largest |JAX logit| (both sides round bf16 activations, in other orders);
static ``generate`` and paged ``generate_batch`` tokens equal wherever the
JAX int8 engine's top-2 logit margin exceeds ``MARGIN``, the rule of
``tests/test_torch_serving.py``. Also the JAX test's closeness-to-bf16
bound (``tests/unit/test_int8_inference.py``), the bytes at rest equal to
the JAX engine's ``tree_nbytes``, and Megatron quantize-on-load against the
JAX loader's ``quantize=True``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops.kernels import dequant_int8 as dq

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

MARGIN = 1e-3       # tests/test_torch_serving.py: a token may differ only at a near-tie
LOGIT_ULPS = 2.0    # bf16 ulps of a row's largest |logit|; 1.0 read here
LLAMA = dict(vocab_size=64, max_seq=256, n_layer=2, n_head=2, n_kv_head=1, d_model=128,
             d_ff=256, pos_embedding="rope", norm="rmsnorm", activation="swiglu",
             tie_embeddings=False, norm_eps=1e-6)
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


class _Pair:
    def __init__(self, q_groups):
        self.jmodel = JaxCausalLM(JT.TransformerConfig(remat=False, attention_backend="flash",
                                                       **LLAMA))
        self.jparams = jax.tree.map(np.asarray, JT.init_params(self.jmodel.config,
                                                               jax.random.key(7)))
        self.pmodel = CausalLM(TransformerConfig(**LLAMA))
        self.params = params_from_jax(self.pmodel.config, self.jparams)
        cfg = {"dtype": "int8", "quant": {"weight": {"q_groups": q_groups}},
               "serving": SERVING}
        self.jeng = deepspeed_tpu.init_inference(self.jmodel, params=self.jparams,
                                                 config=dict(cfg))
        self.peng = deepspeed_tpu_torch.init_inference(self.pmodel, params=self.params,
                                                       config=dict(cfg), device="cpu")

    def check_tokens(self, prompts, got, want):
        """Equal, or first differing where the JAX int8 margin is a near-tie.
        Returns the number of generated tokens compared."""
        compared = 0
        for p, g, w in zip(prompts, got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape
            diff = np.nonzero(g != w)[0]
            if diff.size == 0:
                compared += g.size - p.size
                continue
            i = int(diff[0])
            logits = np.asarray(self.jeng.forward(w[None, :i]), np.float32)[0, -1]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < MARGIN, (
                f"tokens differ at {i} where the JAX margin is {top2[1] - top2[0]}")
            compared += i - p.size
        return compared


@pytest.fixture(params=[1, 4], scope="module")
def pair(request, one_device_mesh):
    return _Pair(request.param)


def _ulps(got, want):
    """Largest |got - want| of each row in bf16 ulps of the row's largest |want|."""
    want = np.asarray(want, np.float64)
    diff = np.abs(np.asarray(got, np.float64) - want).max(-1)
    ulp = np.exp2(np.floor(np.log2(np.abs(want).max(-1))) - 7)
    return float((diff / ulp).max())


def _prompts(seed, lengths):
    r = np.random.default_rng(seed)
    return [r.integers(0, LLAMA["vocab_size"], size=n).astype(np.int32) for n in lengths]


def test_weights_rest_as_int8_with_the_jax_engines_bytes(pair):
    lp = pair.peng.params["layers"][0]
    for key in ("wq", "wk", "wv", "wo"):
        assert isinstance(lp["attn"][key], quant.Quantized8)
    for key in ("w_gate", "w_up", "w_down"):
        assert isinstance(lp["mlp"][key], quant.Quantized8)
    assert isinstance(pair.peng.params["lm_head"], quant.Quantized8)    # untied: quantized
    wq = lp["attn"]["wq"]
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    assert pair.peng.params["embed"]["tokens"].dtype == torch.bfloat16
    assert pair.peng.dtype == torch.bfloat16
    assert quant.tree_nbytes(pair.peng.params) == jquant.tree_nbytes(pair.jeng.params)
    # the payloads and scales are the JAX engine's, bit for bit
    jwq = pair.jeng.params["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(wq.q.numpy(), np.asarray(jwq.q)[0])
    np.testing.assert_array_equal(wq.scale.numpy(), np.asarray(jwq.scale)[0])


def test_forward_logits_match_the_jax_int8_engine(pair):
    tok = np.random.default_rng(0).integers(0, LLAMA["vocab_size"], size=(2, 16)).astype(np.int32)
    want = np.asarray(pair.jeng.forward(tok), np.float32)
    got = pair.peng.forward(tok).float().numpy()
    assert got.shape == want.shape
    assert _ulps(got, want) <= LOGIT_ULPS


def test_paged_generate_batch_matches_the_jax_int8_engine(pair):
    prompts = _prompts(1, (5, 40, 130))
    want = pair.jeng.generate_batch(prompts, max_new_tokens=8)
    got = pair.peng.generate_batch(prompts, max_new_tokens=8)
    assert pair.check_tokens(prompts, got, want) > 0
    assert pair.peng._last_serve_actions.get("prefill") == 3
    # prefix caching serves the int8 model too: the repeated prompt hits
    again = [prompts[2], prompts[1]]
    want = pair.jeng.generate_batch(again, max_new_tokens=4)
    got = pair.peng.generate_batch(again, max_new_tokens=4)
    assert pair.check_tokens(again, got, want) > 0
    assert pair.jeng._last_serve_stats == pair.peng._last_serve_stats


def test_static_generate_matches_the_jax_int8_engine(pair):
    ids = np.stack(_prompts(2, (16, 16)))
    want = np.asarray(pair.jeng.generate(ids, max_new_tokens=8))
    got = np.asarray(pair.peng.generate(ids, max_new_tokens=8))
    assert pair.check_tokens(list(ids), got, want) > 0


def test_int8_close_to_bf16_and_smaller(one_device_mesh):
    """The JAX test's bound (``tests/unit/test_int8_inference.py``): int8
    weights perturb the logits of the bf16 engine but stay close, and the
    engine's tree is smaller."""
    model = CausalLM(TransformerConfig(vocab_size=128, n_layer=2, n_head=4, d_model=64,
                                       max_seq=64, attention_backend="xla"))
    params = model.init_params(torch.Generator().manual_seed(0))
    e_bf = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16", device="cpu")
    e_i8 = deepspeed_tpu_torch.init_inference(model, params=params, dtype="int8", device="cpu")
    tok = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    lo_bf = e_bf.forward(tok).float().numpy()
    lo_i8 = e_i8.forward(tok).float().numpy()
    assert np.abs(lo_i8 - lo_bf).max() < 0.15 * max(1.0, np.abs(lo_bf).max())
    assert quant.tree_nbytes(e_i8.params) < quant.tree_nbytes(e_bf.params)
    assert any(isinstance(m, quant.Quantized8) for m in e_i8.params.modules())
    # tied embeddings: the head stays the dense embedding
    assert "lm_head" not in e_i8.params.to_dict()


def test_matmul_sites_dequantize_through_the_wrapper(monkeypatch):
    """Every matmul of a decode step reads its weight through the dequant
    wrapper: 4 attention and 3 MLP matrices a layer, and the untied head."""
    calls = []
    real = dq.dequant_int8

    def counted(q, scale, dtype=torch.bfloat16):
        calls.append(tuple(q.shape))
        return real(q, scale, dtype)

    monkeypatch.setattr(quant, "dequant_int8", counted)
    model = CausalLM(TransformerConfig(**LLAMA))
    eng = deepspeed_tpu_torch.init_inference(model, dtype="int8", device="cpu",
                                             serving=SERVING)
    calls.clear()
    eng.generate_batch(_prompts(3, (9,)), max_new_tokens=2)     # a prefill, a decode
    assert len(calls) == 2 * (7 * LLAMA["n_layer"] + 1)


def test_megatron_quantize_on_load_matches_the_jax_loader(tmp_path):
    from deepspeed_tpu.module_inject.megatron import load_megatron_checkpoint as jax_load
    from deepspeed_tpu_torch.module_inject.megatron import load_megatron_checkpoint
    from tests.unit.test_megatron_inject import (_cfg, _shard_megatron_sd, _to_megatron_sd,
                                                 _write_ckpt)
    jcfg = _cfg()
    params = jax.tree.map(np.asarray, JaxCausalLM(jcfg).init_params(jax.random.key(2)))
    meta = _write_ckpt(tmp_path, _shard_megatron_sd(_to_megatron_sd(params, jcfg, 0), 2, 0), 0)
    pcfg = TransformerConfig(**dataclasses.asdict(jcfg))
    for extra in (True, False):
        want = jax.tree.map(np.asarray, jax_load(meta, jcfg, quantize=True, quantize_groups=4,
                                                 mlp_extra_grouping=extra))
        got = load_megatron_checkpoint(meta, pcfg, quantize=True, quantize_groups=4,
                                       mlp_extra_grouping=extra)
        w_up = got["layers"][0]["mlp"]["w_up"]
        assert isinstance(w_up, quant.Quantized8)
        assert w_up.scale.shape[-1] == (8 if extra else 4)
        back = params_to_jax(pcfg, got)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda x: jquant.Quantized8(q=x.q, scale=x.scale)
                         if hasattr(x, "scale") and not isinstance(x, dict) else x, back,
                         is_leaf=lambda x: hasattr(x, "q") and hasattr(x, "scale")))}
        assert sorted(flat_g) == sorted(jax.tree_util.keystr(p) for p, _ in flat_w)
        for p, v in flat_w:
            np.testing.assert_array_equal(flat_g[jax.tree_util.keystr(p)], np.asarray(v),
                                          err_msg=jax.tree_util.keystr(p))
