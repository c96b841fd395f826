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

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

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
