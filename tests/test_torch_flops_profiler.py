"""The flops profiler (``deepspeed_tpu_torch/profiling/``) against the JAX
package's ``profiling/flops_profiler``.

- The product and convolution flops of one forward equal the
  ``dot_general`` and ``conv_general_dilated`` entries of the JAX walk's
  breakdown (``flops_from_jaxpr``) on the same 2-layer narrow models (a
  Llama-style and a GPT-2-style ``CausalLM``, a ``BertModel``, plain
  attention) and on a small NHWC convolution net: limit 0.
- The totals differ only where torch runs one aten op for what the JAX
  walk sees as several primitives (softmax, the norms, gelu, silu): the
  difference must lie within the JAX count's non-product flops (4-6 % of
  the total on these models), the only flops the two counts classify
  differently.
- ``number_to_string`` prints the JAX strings; the ``FlopsProfiler`` and
  ``get_model_profile`` surfaces; a hand-written kernel's op counts 0, as
  the walk counts a ``pallas_call``; the engine writes ``output_file`` at
  ``profile_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxTConfig
from deepspeed_tpu.profiling.flops_profiler import flops_from_jaxpr
from deepspeed_tpu.profiling.flops_profiler import number_to_string as jax_number_to_string
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import bert as pbert
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.profiling.flops_profiler import (FlopsProfiler, get_model_profile,
                                                          number_to_string)
from deepspeed_tpu_torch.profiling.flops_profiler.profiler import count_flops

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LM = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=16, remat=False,
          attention_backend="xla")
FAMILIES = {"llama": dict(pos_embedding="rope", norm="rmsnorm", activation="swiglu"),
            "gpt2": {}}
BERT = dict(vocab_size=64, max_seq=16, n_layer=2, n_head=2, d_model=32, d_ff=64, remat=False,
            attention_backend="xla")


def _jax_count(fn, *args):
    breakdown = {}
    total = flops_from_jaxpr(jax.make_jaxpr(fn)(*args).jaxpr, breakdown)
    return total, breakdown


def _hold(port, jax_side):
    (pt, pb), (jt, jb) = port, jax_side
    for k in ("dot_general", "conv_general_dilated"):
        assert pb.get(k, 0.0) == jb.get(k, 0.0), k
    assert abs(pt - jt) <= jt - jb.get("dot_general", 0.0) - jb.get("conv_general_dilated", 0.0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_causal_lm_products_equal_the_jax_walk(family):
    cfg = dict(LM, **FAMILIES[family])
    jm, pm = JaxCausalLM(JaxTConfig(**cfg)), CausalLM(TransformerConfig(**cfg))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    tok = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    _hold(count_flops(pm.forward, params_from_jax(pm.config, jp), torch.from_numpy(tok).long()),
          _jax_count(jm.forward, jp, tok))


def test_bert_products_equal_the_jax_walk():
    jm = jbert.BertModel(jbert.BertConfig(**BERT), with_mlm_head=True)
    pm = pbert.BertModel(pbert.BertConfig(**BERT), with_mlm_head=True)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    pp = params_from_jax(pm.config, jp)
    tok = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    _hold(count_flops(pm.forward, pp, torch.from_numpy(tok).long(), torch.from_numpy(mask)),
          _jax_count(jm.forward, jp, tok, mask))


def test_convolution_flops_equal_the_jax_walk():
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w1 = r.standard_normal((3, 3, 6, 10)).astype(np.float32)      # HWIO
    w2 = r.standard_normal((1, 1, 10, 4)).astype(np.float32)
    b = r.standard_normal(10).astype(np.float32)

    def jfn(x, w1, w2, b):
        dn = ("NHWC", "HWIO", "NHWC")
        h = jax.lax.conv_general_dilated(x, w1, (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn)
        h = jnp.tanh(h + b)
        return jax.lax.conv_general_dilated(h, w2, (2, 2), "VALID", dimension_numbers=dn)

    def pfn(x, w1, w2, b):
        h = torch.tanh(F.conv2d(x.permute(0, 3, 1, 2), w1, b, padding=1))
        return F.conv2d(h, w2, stride=2).permute(0, 2, 3, 1)

    oihw = lambda w: torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    port = count_flops(pfn, torch.from_numpy(x), oihw(w1), oihw(w2), torch.from_numpy(b))
    want = _jax_count(jfn, x, w1, w2, b)
    assert want[1]["conv_general_dilated"] > 0
    _hold(port, want)


def test_a_kernel_op_counts_zero():
    """Kernel A's op (``dstpu::flash_fwd``, its plain version on the CPU)
    is not an aten op: its work is not counted, as the walk counts a
    ``pallas_call`` 0. The plain attention's einsums count."""
    r = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 16, 2, 8), generator=r) for _ in range(3))
    kernel, kb = count_flops(lambda: torch.ops.dstpu.flash_fwd(q, k, v, None, None, None,
                                                               True, None))
    plain, pb = count_flops(lambda: fa.flash_attention_plain(q, k, v))
    assert kernel == 0.0 and kb == {}
    assert pb["dot_general"] == 2 * (2 * 2 * 16 * 16 * 8)


@pytest.mark.parametrize("num", [0, 42, 999.5, 1000, 2_500_000, 1.5e9, 1.5e12, -3e6])
@pytest.mark.parametrize("units", [None, "G", "M", "K", ""])
def test_number_to_string_is_the_jax_one(num, units):
    for precision in (0, 2, 3):
        assert number_to_string(num, units, precision) == \
            jax_number_to_string(num, units, precision)


def test_profiler_class():
    prof = FlopsProfiler()
    prof.start_profile()
    x, w = torch.zeros((16, 32)), torch.zeros((32, 8))
    prof.profile_fn(lambda x, w: x @ w, x, w)
    assert prof.get_total_flops() == 2 * 16 * 32 * 8
    assert prof.get_total_macs() == prof.get_total_flops() / 2
    assert prof.get_total_params() == 16 * 32
    assert prof.get_total_flops(as_string=True) == "8.19 K"
    prof.print_model_profile()
    prof.end_profile()
    assert not prof.started
    twice = FlopsProfiler(recompute_fwd_factor=1.0)
    twice.profile_fn(lambda a: a @ a, torch.zeros((8, 8)))
    assert twice.get_total_flops() == 2 * twice.flops


def test_get_model_profile():
    f, m, p = get_model_profile(fn=lambda a: a @ a, args=(torch.zeros((64, 64)),),
                                print_profile=False, as_string=True)
    assert (f, m, p) == ("524.29 K", "262.14 KMACs", "4.10 K")
    model = CausalLM(TransformerConfig(**LM))
    params = model.init_params(torch.Generator().manual_seed(0))
    flops, macs, n = get_model_profile(model=model, args=(params, torch.ones((2, 16)).long()),
                                       print_profile=True, as_string=False)
    assert n == model.num_parameters and macs == flops / 2
    est = 2.0 * model.num_parameters * 2 * 16
    assert est / 3 < flops < est * 3


def test_engine_writes_the_profile_at_its_step(tmp_path):
    out = tmp_path / "flops.txt"
    model = CausalLM(TransformerConfig(**LM))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "flops_profiler": {"enabled": True, "profile_step": 2,
                                   "output_file": str(out)}})
    batch = {"input_ids": np.random.default_rng(0).integers(0, 64, (2, 16))}
    engine.train_batch(batch)
    assert not out.exists() and engine.flops_profiler is None
    engine.train_batch(batch)
    lines = out.read_text().splitlines()
    assert lines[1] == "flops profile at step 2"
    prof = engine.flops_profiler
    assert lines[3] == f"fwd flops:    {prof.get_total_flops(as_string=True)}"
    # the loss of one micro-batch (2 rows): the forward's products, the head's included
    assert prof.breakdown["dot_general"] == count_flops(
        lambda: model.forward(engine.state.params, torch.from_numpy(batch["input_ids"])))[
        1]["dot_general"]
