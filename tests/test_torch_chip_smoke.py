"""The measures and helpers of ``chip_smoke.py`` that need no card, on the
CPU: the per-row bf16-ulp measure, the teacher-forced logits of the serving
and static-generate paths with a planted kernel fault (which must read above
the limit that holds the card's logits to the CPU's), and the profile's
mapping of kernel names to their classes."""

import numpy as np
import pytest
import torch

import chip_smoke
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

LLAMA = dict(vocab_size=64, max_seq=384, n_layer=2, n_head=4, n_kv_head=2, d_model=256,
             d_ff=512, pos_embedding="rope", norm="rmsnorm", activation="swiglu",
             tie_embeddings=False, norm_eps=1e-6)


def test_row_ulp_errs_reads_each_row():
    ref = torch.tensor([[1.0, -0.5, 0.25], [3.0, 2.0, 1.0], [0.0, 0.0, 0.0]])
    out = ref.clone()
    out[0, 1] += 2.0**-7          # 1 ulp of a row whose largest |value| is 1
    out[1, 2] += 3 * 2.0**-6      # 3 ulps of a row whose largest is 3 (binade [2, 4))
    errs = chip_smoke.row_ulp_errs(out, ref)
    assert errs.tolist() == [1.0, 3.0, 0.0]
    assert chip_smoke.ulp_err(out, ref) == 3.0
    out[2, 0] = 1e-3              # a zero row that is not zero reads inf without a floor
    assert chip_smoke.row_ulp_errs(out, ref)[2] == float("inf")
    assert chip_smoke.row_ulp_errs(out, ref, floor=1.0)[2] < 1.0


@pytest.fixture(scope="module")
def engine():
    model = CausalLM(TransformerConfig(**LLAMA))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    return deepspeed_tpu_torch.init_inference(
        model, params=params, dtype="fp32", device="cpu",
        serving={"block_size": 128, "max_running": 2, "prefix_caching": "off"})


def test_paged_logits_are_teacher_forced(engine):
    """paged_logits returns one row per generated position; fed the engine's
    own greedy tokens, each row's argmax is the token the engine sampled."""
    prompt = np.random.default_rng(1).integers(0, LLAMA["vocab_size"], size=140)
    toks = np.asarray(engine.generate_batch([prompt], max_new_tokens=6)[0])
    logits = chip_smoke.paged_logits(engine, toks[:-1], prompt.size)
    assert logits.shape == (6, LLAMA["vocab_size"])
    assert logits.argmax(-1).tolist() == toks[prompt.size:].tolist()


@pytest.mark.parametrize("fault", ["flash_kv_head_shifted", "flash_last_key_tile_dropped"])
def test_slice_parity_sees_a_planted_flash_fault(engine, fault):
    """Through the paged path the sound logits read 0 against themselves at
    every position; kernel A's planted faults move them above the limit."""
    prompt = np.random.default_rng(2).integers(0, LLAMA["vocab_size"], size=200)
    toks = np.asarray(engine.generate_batch([prompt], max_new_tokens=5)[0])[:-1]
    want = chip_smoke.paged_logits(engine, toks, prompt.size)
    with chip_smoke.planted_attention_fault(fault):
        bad = chip_smoke.paged_logits(engine, toks, prompt.size)
    rec, failures = chip_smoke.logit_parity(want.clone(), want, {fault: bad})
    assert rec["positions_compared"] == 5 and rec["ulp_err"] == 0.0
    assert rec["fault_ulp_err"][fault] > chip_smoke.LOGIT_ULP_TOL and not failures
    _, failures = chip_smoke.logit_parity(bad, want, {})
    assert failures                                   # a faulted run fails the phase


def test_generate_parity_sees_a_planted_decode_fault(engine):
    """cached_logits holds every prompt position and every fed token; the
    dense decode kernel's planted fault reads above the limit."""
    ids = np.random.default_rng(3).integers(0, LLAMA["vocab_size"], size=(2, 100))
    out = engine.generate(ids, max_new_tokens=5)[:, :-1]
    want = chip_smoke.cached_logits(engine, out, 100)
    assert want.shape == (2, 104, LLAMA["vocab_size"])
    assert want[:, 99:].argmax(-1).tolist() == engine.generate(ids, max_new_tokens=5)[:, 100:].tolist()
    with chip_smoke.planted_attention_fault("decode_kv_head_shifted"):
        bad = chip_smoke.cached_logits(engine, out, 100)
    rec, failures = chip_smoke.logit_parity(want.flatten(0, 1), want.flatten(0, 1),
                                            {"decode_kv_head_shifted": bad.flatten(0, 1)})
    assert rec["positions_compared"] == 208 and rec["ulp_err"] == 0.0 and not failures


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 128>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, float const*, float const*, int, int, "
     "int, int, float)", "flash_attention_fwd"),
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelI6__halfLi64EEEv14CUtensorMap_st",
     "flash_attention_fwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, 128>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, float const*, float const*, float const*, "
     "float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, float, float)",
     "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__half, 64>(__half const*)",
     "flash_bwd_dq"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
])
def test_kernel_class_maps_the_attention_kernels(name, cls):
    assert chip_smoke._kernel_class(name) == cls
