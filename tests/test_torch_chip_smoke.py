"""The measures and helpers of ``chip_smoke.py`` that need no card, on the
CPU: the per-row bf16-ulp measure, the teacher-forced logits of the serving
and static-generate paths with a planted kernel fault (which must read above
the limit that holds the card's logits to the CPU's), the planted faults of
the backward kernels C and D, of the fused CE forward F and of A, C and D
with a block layout (each must read above its limit against the sound plain
version), the train_sparse layout's live blocks, the build phase's ptxas
records and spill gate, the profile's mapping of kernel names to their
classes, and phase resume's helpers (its dataset, launch rule, tag size,
state fingerprint) and the phase itself at a tiny size, and phase telemetry
at a tiny size."""

import json
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

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
    ("void (anonymous namespace)::paged_decode_combine_kernel<__nv_bfloat16, 128, 1>(float "
     "const*, int const*, __nv_bfloat16*, int, int, int, int)", "paged_decode_attention"),
    ("void (anonymous namespace)::dense_decode_combine_kernel<__half, 64, 4>(float const*, "
     "__half*, int, int, int, int)", "dense_decode_attention"),
    ("void (anonymous namespace)::dense_decode_kernel<__nv_bfloat16, 128, 1>(__nv_bfloat16 "
     "const*)", "dense_decode_attention"),
    ("void (anonymous namespace)::sr_quantize_kernel<__nv_bfloat16, 0, true>(__nv_bfloat16 "
     "const*, __nv_bfloat16*, (anonymous namespace)::Leaf, float const*, float, unsigned int, "
     "unsigned int)", "sr_quantize"),
    ("void (anonymous namespace)::sr_absmax_kernel<__half>(__half const*, "
     "(anonymous namespace)::Leaf, unsigned int*)", "sr_absmax"),
    ("void (anonymous namespace)::sr_scale_kernel(float*, long, float)", "sr_absmax"),
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


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_decode_split_faults_read_above_the_limit(kind):
    """The decode kernels' split algorithm in plain PyTorch reads within
    ULP_TOL of the one-pass plain version (bf16 in and out), and its planted
    faults (the middle split's partial dropped, the combine's rescale left
    out) read above it."""
    r = np.random.default_rng(7)
    bf = lambda *shape: torch.from_numpy(r.normal(size=shape).astype(np.float32)).bfloat16()
    q = bf(3, 8, 64)
    if kind == "paged":
        kp, vp = bf(19, 128, 2, 64), bf(19, 128, 2, 64)
        bt = torch.from_numpy((r.permutation(18)[:18] + 1).reshape(3, 6).astype(np.int32))
        pos = torch.tensor([700, 0, 300], dtype=torch.int32)
        args = (q, kp, vp, bt, pos)
        ref = pda.paged_decode_attention_plain(*args)
        sound = pda.paged_decode_attention_plain(*args, splits=6)
        faults = chip_smoke._split_faults(pda.paged_decode_partials_plain(*args),
                                          q.dtype, pda.merge_partials_plain)
    else:
        ck, cv = bf(3, 768, 2, 64), bf(3, 768, 2, 64)
        ref = dda.decode_attention_plain(q, ck, cv, 600)
        sound = dda.decode_attention_plain(q, ck, cv, 600, splits=6)
        faults = chip_smoke._split_faults(dda.decode_partials_plain(q, ck, cv, 600),
                                          q.dtype, dda.merge_partials_plain)
    assert chip_smoke.ulp_err(sound, ref) <= chip_smoke.ULP_TOL
    assert set(faults) == {"mid_split_dropped", "combine_unscaled"}
    for name, bad in faults.items():
        assert chip_smoke.ulp_err(bad, ref) > chip_smoke.ULP_TOL, name


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
    assert chip_smoke.spilling_kernels(rows) == {"fused_ce_fwd_kernel fp16": 8}


@pytest.mark.parametrize("kernel", ["paged_decode_kernel", "paged_decode_combine_kernel",
                                    "dense_decode_kernel", "dense_decode_combine_kernel"])
def test_spill_gate_holds_the_decode_kernels(kernel):
    """The decode kernels and their combine kernels have rows of their own
    (one per dtype and head dim, the worst group size), and a spill in any
    of them fails the build phase."""
    name = f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}I13__nv_bfloat16Li64ELi8EEEvPKT_"
    rows, _ = chip_smoke.ptxas_summary({"decode": _PTXAS.format(name=name, spill=0)
                                        + _PTXAS.format(name=name.replace("Li8E", "Li2E"),
                                                        spill=12)})
    assert set(rows) == {f"{kernel} bf16 hd64"}
    assert chip_smoke.spilling_kernels(rows) == {f"{kernel} bf16 hd64": 24}


@pytest.mark.parametrize("kernel", ["sr_quantize_kernel", "sr_absmax_kernel", "sr_scale_kernel"])
def test_spill_gate_holds_k8_and_its_scale_pass(kernel):
    """K8's quantization kernel and its scale pass's two kernels have rows
    of their own (one per dtype, the worst over their template arguments),
    and a spill in any of them fails the build phase."""
    name = f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}I13__nv_bfloat16Li2ELb1EEEvPKT_"
    rows, _ = chip_smoke.ptxas_summary({"sr": _PTXAS.format(name=name, spill=0)
                                        + _PTXAS.format(name=name.replace("Li2E", "Li3E"),
                                                        spill=8)})
    assert set(rows) == {f"{kernel} bf16"}
    assert chip_smoke.spilling_kernels(rows) == {f"{kernel} bf16": 16}


@pytest.mark.parametrize("dtype,sizes,groups,bits,faults", [
    (torch.bfloat16, (3003,) * 5, 1365, 8, {"reciprocal_scale"}),     # 11-element groups
    (torch.float32, (777777,) * 3, 7, 8, {"piece_left_out"}),          # groups spanning leaves
])
def test_sr_scale_faults_read_above_zero(dtype, sizes, groups, bits, faults):
    """The planted faults of K8's scale pass differ from the sound plain
    scales in some group: the reciprocal of qmax where there are >= 1000
    groups, the max piece of a group spanning leaves left out."""
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    gen = torch.Generator().manual_seed(5)
    leaves = [torch.randn(n, generator=gen).mul_(0.02).to(dtype) for n in sizes]
    sound = qk._span_scales(leaves, groups, bits)[0]
    planted = chip_smoke._scale_faults(qk, leaves, groups, bits)
    assert faults <= set(planted)
    for f in faults:
        assert int((planted[f] != sound).sum()) > 0, f


@pytest.mark.parametrize("kind,S,causal", [("fixed128", 1024, True), ("bigbird64", 512, False)])
def test_layout_faults_read_above_the_limit(kind, S, causal):
    """The layout faults planted in A, C and D (the layout ignored, the
    middle live tile of the longest list dropped, and at blocks of 64 each
    partial tile taken whole) read above ULP_TOL against the sound plain
    versions, in the kernel phase's measure (bf16 inputs, GRAD_FLOOR for
    the gradients); the sound layout reads 0 against itself."""
    B, H, KV, Hd = 1, 4, 2, 64
    r = np.random.default_rng(S)
    bf = lambda *shape: torch.from_numpy(r.normal(size=shape).astype(np.float32)).bfloat16()
    q, k, v, do = bf(B, S, H, Hd), bf(B, S, KV, Hd), bf(B, S, KV, Hd), bf(B, S, H, Hd)
    lay = chip_smoke.sparse_layout(kind, H, S)
    keep = fa._layout_keep(lay, S, H, causal)
    kw = {"causal": causal, "block_layout": lay}
    o, lse = fa.flash_attention_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    wanted = ("layout_ignored", "tile_dropped") + (("partial_mask_left_out",)
                                                   if kind.endswith("64") else ())
    runs = {"fwd": lambda k_: [fa.flash_attention_plain(q, k, v, **k_)[0]],
            "dq": lambda k_: [fa.flash_attention_dq_plain(*args, **k_)],
            "dkv": lambda k_: list(fa.flash_attention_dkv_plain(*args, **k_))}
    for kern, run in runs.items():
        floor = 0.0 if kern == "fwd" else chip_smoke.GRAD_FLOOR
        sound = run(kw)
        faults = chip_smoke._layout_faults(fa, kern, keep, S, causal, KV, wanted)
        assert set(faults) == set(wanted)
        for name, bad_layout in faults.items():
            bad = run({**kw, "block_layout": bad_layout})
            err = max(chip_smoke.ulp_err(b, s, floor) for b, s in zip(bad, sound))
            assert err > chip_smoke.ULP_TOL, (kern, name, err)


def test_the_train_sparse_layout_and_its_live_pairs():
    """The train_sparse layout at S 4096: 192 of the 528 causal 128-blocks a
    head (34.4 % of the causal pairs), and the kernels' lists hold one
    128 x 128 tile a live block for A and two for C and D."""
    S, H = chip_smoke.SPARSE_SEQ, 32
    keep = fa._layout_keep(chip_smoke.sparse_layout("fixed128", H, S), S, H, True)
    assert int(keep.sum()) == 192 * H
    assert chip_smoke.live_pairs(keep, S, True) / (H * S * (S + 1) / 2) == pytest.approx(
        0.344, abs=5e-4)
    for kern, per_block in (("fwd", 1), ("dq", 2), ("dkv", 2)):
        offsets, entries = fa.live_tiles(keep, S, True, kern, H)
        assert len(entries) == per_block * 192 * H and not (entries & 1).any()   # no partial
    dense = torch.ones((H, 32, 32), dtype=torch.bool).tril()
    assert chip_smoke.live_pairs(dense, S, True) == H * S * (S + 1) // 2


def test_layout_ignored_plants_dense_attention_through_the_model():
    """Through the sparse model (its kernel path: the plain versions on the
    CPU) the planted fault gives the dense model's logits, and the sound run
    differs from them."""
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.sparse_attention import replace_self_attention
    cfg = TransformerConfig(**{**LLAMA, "n_kv_head": 4, "max_seq": 1024,
                               "attention_backend": "flash"})
    model = CausalLM(cfg)
    sparse = replace_self_attention(model, chip_smoke.sparse_config(4))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 64, size=(1, 1024)))
    dense = T.forward(cfg, params, tokens)
    sound = T.forward(sparse.config, params, tokens)
    with chip_smoke._layout_ignored():
        bad = T.forward(sparse.config, params, tokens)
    assert torch.equal(bad, dense) and not torch.allclose(sound, dense)


def test_ptxas_rows_of_the_decode_kernels_at_head_dim_96():
    name = "_ZN12_GLOBAL__N_119paged_decode_kernelI13__nv_bfloat16Li96ELi8EEEvPKT_"
    rows, _ = chip_smoke.ptxas_summary({"decode": _PTXAS.format(name=name, spill=0)})
    assert set(rows) == {"paged_decode_kernel bf16 hd96"}


def test_verify_logits_are_the_decode_logits_and_see_the_planted_fault(engine):
    """verify_logits (windows of 1 .. 8 tokens padded to the engine's
    window of 8, three rows, one idle at the end) gives, position by
    position, paged_logits' rows after the prompt (fp32: the same numbers
    up to summation order); kernel B handed pos instead of pos + t moves
    them above the limit."""
    r = np.random.default_rng(6)
    rows = [(r.integers(0, LLAMA["vocab_size"], size=n + 17), n) for n in (40, 130, 126)]
    rows[2] = (rows[2][0][:126 + 6], 126)          # done early: idle in later steps
    got = chip_smoke.verify_logits(engine, rows)
    want = [chip_smoke.paged_logits(engine, t, n)[1:] for t, n in rows]
    assert [g.shape[0] for g in got] == [17, 17, 6]
    got, want = torch.cat(got), torch.cat(want)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    with chip_smoke.planted_verify_fault():
        bad = torch.cat(chip_smoke.verify_logits(engine, rows))
    rec, failures = chip_smoke.logit_parity(got, want, {"verify_pos_not_advanced": bad})
    assert rec["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL and not failures
    assert rec["fault_ulp_err"]["verify_pos_not_advanced"] > chip_smoke.LOGIT_ULP_TOL


def test_near_tie_rule():
    """Two largest logits within LOGIT_ULP_TOL bf16 ulps of the position's
    largest |logit| (logit_parity's scale) are a near-tie: the ulp of 20 is
    2^-3, so 8 ulps are 1.0; with a logit of -40 in the row they are 2.0."""
    assert chip_smoke.near_tie(torch.tensor([20.0, 19.0, -10.0, 1.0]))
    assert not chip_smoke.near_tie(torch.tensor([20.0, 18.9, -10.0, 1.0]))
    assert chip_smoke.near_tie(torch.tensor([20.0, 18.1, -40.0, 1.0]))
    assert not chip_smoke.near_tie(torch.tensor([20.0, 3.0, -10.0, 1.0]))
    assert chip_smoke.near_tie(torch.tensor([1.0, 0.95]))     # ulp of 1: 2^-7; 8 ulps 1/16


@pytest.fixture(scope="module")
def spec_engine():
    model = CausalLM(TransformerConfig(**LLAMA))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    return deepspeed_tpu_torch.init_inference(
        model, params=params, dtype="fp32", device="cpu",
        serving={"block_size": 128, "max_running": 4,
                 "speculative": {"mode": "ngram", "k": chip_smoke.SPEC_K}})


def test_spec_launch_formula_counts_the_wrappers(spec_engine, monkeypatch):
    """A serve with speculation calls A's wrapper once a layer a prefill and
    B's once a layer a decode and SPEC_WB times a layer a verify (counted
    here at the model's calls: the CUDA counters count on the card only)."""
    from deepspeed_tpu_torch.models import transformer as T
    calls = {"flash_attention_fwd": 0, "paged_decode_attention": 0}
    for name, key in (("flash_attention", "flash_attention_fwd"),
                      ("paged_decode_attention", "paged_decode_attention")):
        real = getattr(T, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(T, name, counted)
    cfg = spec_engine.module.config
    prompts = chip_smoke.spec_prompts(cfg, 0, n=3)
    prompts = [p[:int(n)] for p, n in zip(prompts, (130, 60, 90))]
    spec_engine.generate_batch(prompts, max_new_tokens=12)
    actions = spec_engine._last_serve_actions
    assert actions.get("verify", 0) > 0
    assert calls == chip_smoke.spec_launches(cfg.n_layer, actions)


def test_oracle_serve_is_spec_off_and_divergences_read_near_ties(spec_engine, engine):
    """With the oracle proposer every row equals the spec-off serve and
    most candidates are accepted, and so with a wrong third candidate,
    which is rolled back; a row changed after its prompt is found
    at its first differing token, and judged by the spec-off logits there."""
    cfg = spec_engine.module.config
    prompts = [p[:int(n)] for p, n in zip(chip_smoke.spec_prompts(cfg, 1, n=2), (70, 140))]
    off = engine.generate_batch(prompts, max_new_tokens=10)
    got = chip_smoke._serve_with_proposer(spec_engine, prompts, 10,
                                          chip_smoke.OracleProposer(off, cfg.vocab_size))
    st = spec_engine._last_serve_stats
    assert all(np.array_equal(g, w) for g, w in zip(got, off))
    assert st["verify_steps"] > 0 and st["spec_accepted"] >= 0.75 * st["spec_proposed"]
    assert chip_smoke._divergences(engine, prompts, got, off) == []
    half = chip_smoke._serve_with_proposer(spec_engine, prompts, 10,
                                           chip_smoke.OracleProposer(off, cfg.vocab_size, 2))
    st = spec_engine._last_serve_stats
    assert all(np.array_equal(g, w) for g, w in zip(half, off))
    assert st["spec_rollbacks"] > 0 and st["spec_accepted"] < st["spec_proposed"]
    moved = [g.copy() for g in got]
    moved[1][prompts[1].size + 4] = (moved[1][prompts[1].size + 4] + 1) % cfg.vocab_size
    (d,) = chip_smoke._divergences(engine, prompts, moved, off)
    assert d["row"] == 1 and d["index"] == 4
    logits = chip_smoke.paged_logits(engine, off[1][:prompts[1].size + 4], prompts[1].size)[-1]
    assert d["near_tie"] == chip_smoke.near_tie(logits)


def test_lse_cotangent_fault_reads_above_the_limit():
    """The lse backward's planted fault (the cotangent left out of delta)
    reads above ULP_TOL against the sound plain gradients in the kernel
    phase's measure; the sound row term reads 0 against itself."""
    B, S, H, KV, Hd = 1, 256, 4, 2, 64
    r = np.random.default_rng(9)
    bf = lambda *shape: torch.from_numpy(r.normal(size=shape).astype(np.float32)).bfloat16()
    q, k, v, do = bf(B, S, H, Hd), bf(B, S, KV, Hd), bf(B, S, KV, Hd), bf(B, S, H, Hd)
    dlse = torch.from_numpy(r.normal(size=(B, H, S)).astype(np.float32))
    o, lse = fa.flash_attention_plain(q, k, v)
    sound = chip_smoke.lse_delta(o, do, dlse)
    dropped = chip_smoke.lse_delta(o, do, torch.zeros_like(dlse))
    expected = (do.float() * o.float()).sum(-1).transpose(1, 2) - dlse * 1.4426950408889634
    torch.testing.assert_close(sound, expected, atol=1e-5, rtol=0)
    for run, floor in ((lambda d: [fa.flash_attention_dq_plain(q, k, v, do, lse, d)], 1),
                       (lambda d: list(fa.flash_attention_dkv_plain(q, k, v, do, lse, d)), 1)):
        good, bad = run(sound), run(dropped)
        err = max(chip_smoke.ulp_err(b, g, chip_smoke.GRAD_FLOOR) for b, g in zip(bad, good))
        assert err > chip_smoke.ULP_TOL


# ----------------------------------------------------------------------- #
# phase resume's helpers

RESUME_TINY = dict(n_layer=2, n_head=4, d_model=128, d_ff=256, vocab_size=256, max_seq=64)


def test_resume_dataset_is_seeded_motifs():
    data = chip_smoke.resume_dataset(32000, 0)
    assert len(data) == chip_smoke.RESUME_SAMPLES == 64
    periods = []
    for s in data:
        x = s["input_ids"]
        assert x.shape == (chip_smoke.TRAIN_SEQ,) and x.dtype == np.int32
        period = next(p for p in range(8, 33) if np.array_equal(x[p:], x[:-p]))
        periods.append(period)
    assert min(periods) >= 8 and max(periods) <= 32 and len(set(periods)) > 5
    again, other = chip_smoke.resume_dataset(32000, 0), chip_smoke.resume_dataset(32000, 1)
    assert all(np.array_equal(a["input_ids"], b["input_ids"]) for a, b in zip(data, again))
    assert not np.array_equal(data[0]["input_ids"], other[0]["input_ids"])


def _tiny_resume_engine(seed=0, init_seed=1, config=None):
    from deepspeed_tpu_torch.models import llama
    data = chip_smoke.resume_dataset(256, seed, n=16, seq=64)
    return chip_smoke.resume_engine(data, seed, init_seed, config=config, device="cpu",
                                    model=llama("7b", **RESUME_TINY))


def test_train_launch_rule_counts_the_train_cell_rule():
    engine = _tiny_resume_engine()
    want = chip_smoke.train_launch_rule(engine)
    assert want == {"flash_attention_fwd": 8, "flash_attention_bwd_dq": 4,
                    "flash_attention_bwd_dkv": 4, "fused_adam": 21, "fused_ce_fwd": 2,
                    "fused_ce_ds": 2, "fused_ce_dh_gemm": 2, "fused_ce_dw_gemm": 2}


def test_state_bytes_reckons_a_tag(tmp_path):
    """18 B a parameter at bf16 with gas 2 (params 2, masters, mu, nu and
    acc_grads 4 each), plus the scalars; the tag adds only its headers."""
    engine = _tiny_resume_engine()
    n = sum(p.numel() for p in engine.state.params.parameters())
    need = chip_smoke.state_bytes(engine)
    assert 18 * n <= need <= 18 * n + 64
    engine.save_checkpoint(str(tmp_path), tag="t")
    got = chip_smoke.tag_bytes(str(tmp_path / "t"))
    assert need < got < need + 64 * 1024


def test_state_fingerprint_sees_a_step_and_a_failed_load_leaves_it(tmp_path):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import (
        STATE_FILE, CheckpointCorruptError)
    from deepspeed_tpu_torch.utils import fault_injection as fi
    engine = _tiny_resume_engine()
    before = chip_smoke.state_fingerprint(engine)
    assert chip_smoke.state_fingerprint(engine) == before
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.train_batch()             # WarmupLR: lr 0 at step 0, the params move at step 1
    engine.train_batch()
    engine._rng.manual_seed(5)       # no dropout here: the stream moves only if set
    after = chip_smoke.state_fingerprint(engine)
    changed = {k for k in before if before[k] != after[k]}
    assert {"counters.global_steps", "params.embed.tokens", "master.layers.attn.wq",
            "opt_state_flat.leaf_0", "rng"} <= changed
    fi.bit_flip(str(tmp_path / "t" / STATE_FILE))
    with pytest.raises(CheckpointCorruptError):
        engine.load_checkpoint(str(tmp_path), tag="t")
    assert chip_smoke.state_fingerprint(engine) == after


def test_loss_gap():
    assert chip_smoke.loss_gap([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert chip_smoke.loss_gap([1.1, 2.0], [1.0, 2.5]) == pytest.approx(0.2)


def test_resume_phase_runs_its_checks_on_the_cpu(monkeypatch, tmp_path, capsys):
    """phase_resume at the tiny shape on the CPU (no kernels, so no launch
    rule): bit-equal resumed losses and masters, both faults above 0, the
    corrupt load raising with the state untouched, the tag deleted."""
    import json

    from deepspeed_tpu_torch.models import llama

    class Accelerator:
        def reset_peak_memory_stats(self):
            pass

        def max_memory_allocated(self):
            return 0

    real, real_dataset = chip_smoke.resume_engine, chip_smoke.resume_dataset
    monkeypatch.setattr(chip_smoke, "resume_engine",
                        lambda data, seed, init_seed, config=None: real(
                            data, seed, init_seed, config=config, device="cpu",
                            model=llama("7b", **RESUME_TINY)))
    monkeypatch.setattr(chip_smoke, "resume_dataset",
                        lambda vocab, seed: real_dataset(RESUME_TINY["vocab_size"], seed, seq=64))
    monkeypatch.setattr(chip_smoke, "train_launch_rule", lambda engine: {})
    monkeypatch.setattr(chip_smoke, "RESUME_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    import deepspeed_tpu_torch.accelerator as accel
    monkeypatch.setattr(accel, "get_accelerator", lambda *a: Accelerator())
    chip_smoke.phase_resume({}, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "resume" and line["resumed_equal"]
    assert line["losses_resumed"] == line["losses_uninterrupted"]
    assert min(line["fault_loss_gap"].values()) > 0.0
    assert not (tmp_path / "ckpt").exists()


# ---- phase ingest: the HF and Megatron writers, its faults, the phase ----

INGEST_TINY = {
    "llama": {"model_type": "llama", "vocab_size": 256, "hidden_size": 128,
              "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
              "num_key_value_heads": 2, "max_position_embeddings": 1024, "rms_norm_eps": 1e-05,
              "tie_word_embeddings": False},
    "gpt2": {"model_type": "gpt2", "vocab_size": 256, "n_positions": 256, "n_embd": 128,
             "n_layer": 12, "n_head": 2},
    "bloom": {"model_type": "bloom", "vocab_size": 256, "hidden_size": 128, "n_layer": 24,
              "n_head": 2},
    "gpt_neox": {"model_type": "gpt_neox", "vocab_size": 256, "hidden_size": 192,
                 "num_hidden_layers": 44, "num_attention_heads": 2, "intermediate_size": 256,
                 "max_position_embeddings": 256, "rotary_pct": 0.25,
                 "use_parallel_residual": True, "tie_word_embeddings": False},
}


def _tiny_checkpoint(d, model_type, layers=2, seed=0, shard_bytes=None):
    """A tiny model of ``model_type`` written by the phase's HF writer in
    bf16; returns (config, the params written)."""
    from deepspeed_tpu_torch.module_inject import policy_for
    hf = {**INGEST_TINY[model_type], chip_smoke._LAYER_KEY[model_type]: layers}
    cfg = policy_for(model_type).zoo_config(hf)
    params = CausalLM(cfg).init_params(torch.Generator().manual_seed(seed),
                                       dtype=torch.bfloat16)
    chip_smoke.write_hf_checkpoint(str(d), hf, chip_smoke.hf_entries(
        model_type, cfg, params, torch.bfloat16), shard_bytes=shard_bytes)
    return cfg, params


@pytest.mark.parametrize("model_type", sorted(INGEST_TINY))
def test_hf_writer_is_read_back_by_the_jax_loader(model_type, tmp_path):
    """The writer is the inverse of each policy's map_params: the JAX
    package's loader (the safetensors library's reader) reads its shards
    and index to the tree written, and so does the port's loader, bit for
    bit."""
    import jax
    from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
    cfg, params = _tiny_checkpoint(tmp_path, model_type, shard_bytes=200_000)
    with open(tmp_path / "model.safetensors.index.json") as f:
        assert len(set(json.load(f)["weight_map"].values())) > 1     # sharded
    _, jtree = jax_load(str(tmp_path))
    want = params_to_jax(cfg, params.map(lambda t: t.float()))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jtree, want)
    _, tree = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16)
    assert not chip_smoke._equal_leaves(tree, params)


def test_safetensors_writer_matches_the_library(tmp_path):
    from safetensors.numpy import load_file
    t = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
         "b": torch.ones(3, dtype=torch.float32)}
    entries = [(k, tuple(v.shape), v.dtype, lambda v=v: v) for k, v in t.items()]
    n = chip_smoke.write_safetensors(str(tmp_path / "x.safetensors"), entries)
    assert n == (tmp_path / "x.safetensors").stat().st_size
    got = load_file(str(tmp_path / "x.safetensors"))
    np.testing.assert_array_equal(got["b"], t["b"].numpy())
    np.testing.assert_array_equal(got["a"].view(np.int16), t["a"].view(torch.int16).numpy())


def test_untransposed_qk_is_planted_through_the_loader(tmp_path):
    from deepspeed_tpu_torch.module_inject import POLICIES, load_hf_checkpoint
    _, params = _tiny_checkpoint(tmp_path, "llama")
    real = POLICIES["llama"]
    with chip_smoke.untransposed_qk():
        _, faulted = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16)
    assert POLICIES["llama"] is real
    bad = chip_smoke._equal_leaves(faulted, params)
    assert sorted(bad) == ["layers.0.attn.wk", "layers.0.attn.wq", "layers.1.attn.wk",
                           "layers.1.attn.wq"]
    assert torch.equal(faulted["layers"][0]["attn"]["wq"], params["layers"][0]["attn"]["wq"].t())


def test_missing_shard_faults_raise_and_leave_the_checkpoint(tmp_path):
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
    _, params = _tiny_checkpoint(tmp_path, "llama", shard_bytes=200_000)
    before = sorted(os.listdir(tmp_path))
    raised = chip_smoke.missing_shard_faults(str(tmp_path), load_hf_checkpoint)
    assert raised["shard_dropped_from_index"].startswith("KeyError")
    assert raised["shard_missing_on_disk"].startswith("FileNotFoundError")
    assert sorted(os.listdir(tmp_path)) == before
    _, tree = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16)
    assert not chip_smoke._equal_leaves(tree, params)


def test_megatron_writer_is_read_back_by_the_jax_loader(tmp_path):
    import dataclasses
    import jax
    from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
    from deepspeed_tpu.module_inject.megatron import load_megatron_checkpoint
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    cfg = TransformerConfig(vocab_size=64, max_seq=32, n_layer=2, n_head=4, d_model=32,
                            d_ff=64, pos_embedding="learned", attn_bias=True)
    params = CausalLM(cfg).init_params(torch.Generator().manual_seed(0))
    meta = chip_smoke.write_megatron_checkpoint(str(tmp_path), params, tp=2)
    jtree = load_megatron_checkpoint(meta, JaxConfig(**dataclasses.asdict(cfg)))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jtree,
                 params_to_jax(cfg, params))


def test_ingest_phase_runs_its_checks_on_the_cpu(monkeypatch, tmp_path, capsys):
    """phase_ingest at tiny widths on the CPU (bf16 plain versions against
    fp32 ones; no kernels, so no launch rule): the leaves bit-equal, every
    served row equal to the in-memory engine's, the planted faults shown,
    the three families and the Megatron json through, the checkpoints
    deleted."""
    class Accelerator:
        def reset_peak_memory_stats(self):
            pass

        def max_memory_allocated(self):
            return 0

    import deepspeed_tpu_torch.accelerator as accel
    monkeypatch.setattr(chip_smoke, "INGEST_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "INGEST_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(chip_smoke, "SHARD_BYTES", 400_000)
    monkeypatch.setattr(chip_smoke, "LLAMA2_7B_HF", INGEST_TINY["llama"])
    monkeypatch.setattr(chip_smoke, "INGEST_FAMILIES", {
        "gpt2-tiny": INGEST_TINY["gpt2"], "bloom-tiny": INGEST_TINY["bloom"],
        "gpt-neox-tiny": INGEST_TINY["gpt_neox"]})
    monkeypatch.setattr(chip_smoke, "serve_launch_rule", lambda cfg, actions: {
        "flash_attention_fwd": 0, "paged_decode_attention": 0})
    monkeypatch.setattr(chip_smoke, "prefill_launch_rule", lambda cfg, n: 0)
    real_megatron = chip_smoke._megatron_serve
    monkeypatch.setattr(chip_smoke, "_megatron_serve", lambda seed: real_megatron(
        seed, model=CausalLM(TransformerConfig(vocab_size=256, max_seq=256, n_layer=2,
                                               n_head=2, d_model=128, attn_bias=True))))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(accel, "get_accelerator", lambda *a: Accelerator())
    chip_smoke.phase_ingest({}, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "ingest" and line["leaves_equal"] and line["shards"] > 1
    assert line["rows_equal_in_memory"] == line["requests"] == 12
    fault = line["fault_untransposed_qk"]
    assert fault["rows_differ"] > 0 or fault["ulp_err"] > chip_smoke.LOGIT_ULP_TOL
    assert all(line["fault_missing_shard"].values())
    assert sorted(line["families"]) == ["bloom-tiny", "gpt-neox-tiny", "gpt2-tiny"]
    assert line["families"]["gpt-neox-tiny"]["head_dim"] == 96
    assert all(f["ulp_err"] <= chip_smoke.LOGIT_ULP_TOL for f in line["families"].values())
    assert line["megatron"]["rows_equal"] == 2
    assert not (tmp_path / "ckpt").exists()


# ---- phase telemetry at a tiny size ----

class _VirtualClock:
    """The serving code's event clock in the telemetry phase's CPU test:
    ``monotonic_ns`` moves only when planted device time is paid at a token
    read, so the clock check reads the same on a loaded machine as on an
    idle one (``perf_counter`` stays the host's)."""

    def __init__(self):
        self.ns = time.monotonic_ns()
        self.pending_ms = []

    def monotonic_ns(self):
        return self.ns

    def perf_counter(self):
        return time.perf_counter()

    def pay(self):
        while self.pending_ms:
            self.ns += int(self.pending_ms.pop() * 1e6)


def test_telemetry_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    """phase_telemetry at tiny widths on the CPU (fp32, no kernels, so no
    launch rule): tokens and train losses equal with telemetry on and off,
    the registry's counters, the snapshot and the trace valid, the
    host-sync budget, the decode clock sound and its early-clock copy
    caught (the planted device time is paid at the next token read, as on
    the card, on a virtual clock), and train/mfu against the phase's own
    figure under DS_PEAK_TFLOPS."""
    import types

    from deepspeed_tpu_torch.accelerator.cuda_accelerator import CPU_Accelerator
    from deepspeed_tpu_torch.inference import engine as ie
    from deepspeed_tpu_torch.inference import scheduler as sched
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.monitor import events

    tiny = dict(n_layer=2, d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=256)
    clock = _VirtualClock()
    read = CPU_Accelerator.to_host

    def to_host(self, t):
        clock.pay()                          # queued device time lands before the read
        return read(self, t)

    class Event:
        def __init__(self):
            self.ns = clock.ns

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.ns - self.ns) / 1e6

    def tiny_llama(seed):
        model = llama("7b", **tiny)
        return model, model.init_params(torch.Generator().manual_seed(seed))

    def tiny_train_setup(seed, config=None):
        model = llama("7b", **{**tiny, "max_seq": 128})
        params = model.init_params(torch.Generator().manual_seed(seed))
        engine = chip_smoke._train_engine(model, params, config, device="cpu")
        rng = np.random.default_rng(seed + 2)
        ids = rng.integers(0, tiny["vocab_size"], size=(config["train_batch_size"], 128))
        return model, engine, {"input_ids": torch.from_numpy(ids)}

    vtime = types.SimpleNamespace(monotonic_ns=clock.monotonic_ns,
                                  perf_counter=clock.perf_counter)
    for module in (ie, sched, events, chip_smoke):
        monkeypatch.setattr(module, "time", vtime)
    monkeypatch.setattr(CPU_Accelerator, "to_host", to_host)
    monkeypatch.setattr(chip_smoke, "TEL_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TEL_DTYPE", "fp32")
    monkeypatch.setitem(chip_smoke.TRAIN_CONFIG, "bf16", {"enabled": False})
    monkeypatch.setattr(chip_smoke, "_llama7b", tiny_llama)
    monkeypatch.setattr(chip_smoke, "_train_setup", tiny_train_setup)
    monkeypatch.setattr(chip_smoke, "train_launch_rule", lambda engine: {})
    no_kernels = {"flash_attention_fwd": 0, "paged_decode_attention": 0}
    monkeypatch.setattr(chip_smoke, "serve_launch_rule", lambda cfg, actions: no_kernels)
    monkeypatch.setattr(chip_smoke, "registry_launch_rule", lambda cfg, counters: no_kernels)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 128)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 4)
    monkeypatch.setattr(chip_smoke, "CLOCK_MAX_NEW", 4)
    monkeypatch.setattr(chip_smoke, "_serve_prompts", lambda cfg, seed: [
        np.random.default_rng(seed).integers(0, cfg.vocab_size, size=n) for n in (40, 7)])
    monkeypatch.setattr(chip_smoke, "_cuda_event", Event)
    monkeypatch.setattr(chip_smoke, "_device_sleep_fn",
                        lambda ms: (lambda: clock.pending_ms.append(ms)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setenv("DS_PEAK_TFLOPS", "1e-3")
    chip_smoke._reset_telemetry()
    try:
        chip_smoke.phase_telemetry({}, 0)
    finally:
        from deepspeed_tpu_torch.monitor import get_flight_recorder
        get_flight_recorder().disable()
        chip_smoke._reset_telemetry()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "telemetry" and line["rows_equal"] == line["requests"] == 2
    assert line["trace_valid"] and line["ttft_ms"]["count"] == 2
    assert line["train_losses_equal"] and line["train_syncs_on"] == [1, 1, 1]
    assert line["train_syncs_off"] == [0, 0, 0]
    assert line["decode_clock_ratio"] == 1.0 and line["fault_early_clock_ratio"] == 0.0
    assert line["train_mfu_gauge"] == pytest.approx(line["train_mfu_own"], rel=0.03)
