"""The measures and helpers of ``chip_smoke.py`` that need no card, on the
CPU: the per-row bf16-ulp measure, the teacher-forced logits of the serving
and static-generate paths with a planted kernel fault (which must read above
the limit that holds the card's logits to the CPU's), the planted faults of
the backward kernels C and D and of the fused CE forward F (each must read
above its limit against the sound plain version), the build phase's ptxas
records and spill gate, and the profile's mapping of kernel names to their
classes."""

import numpy as np
import pytest
import torch

import chip_smoke
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce

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


# (B, S, H, KV, Hd, causal, alibi, mask): a ragged causal GQA case (two
# 128-row q tiles, the second partial) and a full one with ALiBi and a mask
@pytest.mark.parametrize("B,S,H,KV,Hd,causal,alibi,mask", [
    (1, 200, 4, 2, 64, True, False, False),
    (2, 130, 2, 1, 64, False, True, True),
])
def test_backward_faults_read_above_the_limit(B, S, H, KV, Hd, causal, alibi, mask):
    """Every planted fault of C and D (the new ones aimed at C's ring and
    its two warpgroups among them) reads above ULP_TOL against the sound
    plain gradients, in the phase's measure (bf16 inputs, GRAD_FLOOR)."""
    r = np.random.default_rng(S + H)
    bf = lambda *shape: torch.from_numpy(r.normal(size=shape).astype(np.float32)).bfloat16()
    q, k, v, do = bf(B, S, H, Hd), bf(B, S, KV, Hd), bf(B, S, KV, Hd), bf(B, S, H, Hd)
    kw = {"causal": causal, "alibi_slopes": None, "mask_bias": None}
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(r.uniform(0.05, 0.4, H).astype(np.float32))
    if mask:
        keep = r.random((B, S)) > 0.2
        keep[:, 0] = keep[:, -1] = True
        kw["mask_bias"] = torch.from_numpy(np.where(keep, 0.0, -1e9).astype(np.float32))
    o, lse = fa.flash_attention_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    fdq, fdkv = chip_smoke._bwd_faults(fa, args, kw)
    assert {"mid_kv_stage_skipped", "lse_delta_rows_shifted_64"} <= set(fdq)
    rdq = fa.flash_attention_dq_plain(*args, **kw)
    rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
    for name, bad in fdq.items():
        assert chip_smoke.ulp_err(bad, rdq, chip_smoke.GRAD_FLOOR) > chip_smoke.ULP_TOL, name
    for name, (bk, bv) in fdkv.items():
        err = max(chip_smoke.ulp_err(bk, rdk, chip_smoke.GRAD_FLOOR),
                  chip_smoke.ulp_err(bv, rdv, chip_smoke.GRAD_FLOOR))
        assert err > chip_smoke.ULP_TOL, name


@pytest.mark.parametrize("N,D,V,bias,tied", [
    (300, 128, 1000, True, False),          # four vocab tiles, the last partial
    (130, 192, 600, False, True),           # a tied head, no bias
])
def test_fused_ce_faults_read_above_the_limit(N, D, V, bias, tied):
    """F's planted faults (the new ones aimed at its mainloop and its
    per-tile partials among them) read above CE_TOL against the sound plain
    forward; the tile schedule with nothing left out reads 0."""
    r = np.random.default_rng(N + V)
    h = torch.from_numpy(r.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy((r.normal(size=(V, D) if tied else (D, V)) * 0.05).astype(np.float32))
    w = w.T if tied else w
    b = torch.from_numpy((r.normal(size=V) * 0.5).astype(np.float32)) if bias else None
    labels = torch.from_numpy(r.integers(0, V, size=N).astype(np.int32))
    coef = torch.full((N,), 1.0 / N)
    nll, lse = fce.fused_ce_fwd_plain(h, w, b, labels)
    ds, _ = fce.fused_ce_ds_plain(h, w, b, labels, lse, coef)
    f, g, dh, dw = chip_smoke._ce_faults(fce, h, w, b, labels, lse, coef, ds)
    assert {"mid_k_chunk_dropped", "vocab_tile_left_out"} <= set(f)
    err = lambda got: max(float((got[0] - nll).abs().max()), float((got[1] - lse).abs().max()))
    for name, got in f.items():
        assert err(got) > chip_smoke.CE_TOL, name
    assert err(fce.fused_ce_combine_plain(fce.fused_ce_fwd_tiles_plain(h, w, b, labels))) < 1e-5


_PTXAS = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
"""


def test_ptxas_records_of_c_and_f_and_the_spill_gate():
    """The build phase's rows for C and F (one per dtype and head dim) and
    its gate: a spill in a TMA + wgmma kernel fails the phase."""
    log = {"flash_attention_bwd": _PTXAS.format(
               name="_ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_st",
               spill=0),
           "fused_cross_entropy": _PTXAS.format(
               name="_ZN12_GLOBAL__N_119fused_ce_fwd_kernelI6__halfLb1EEEv14CUtensorMap_st",
               spill=4)}
    rows, warnings = chip_smoke.ptxas_summary(log)
    assert rows["flash_bwd_dq_kernel bf16 hd128"] == {"registers": 168, "smem_bytes": 0,
                                                      "spill_bytes": 0}
    assert rows["fused_ce_fwd_kernel fp16"]["spill_bytes"] == 8 and not warnings
    assert chip_smoke.wgmma_spills(rows) == {"fused_ce_fwd_kernel fp16": 8}
