"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test skips without a CUDA device (the kernels have no CPU
form; on the CPU the wrappers take the plain versions, which the parity
tests hold to the JAX package). This file imports neither jax nor the JAX
package, so it runs on the machine with the card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda
from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl
from deepspeed_tpu_torch.ops.quantizer import kernels as qk

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

ULP_TOL = 3.0     # bf16 ulps of each output row's largest value (as chip_smoke.py)
LSE_TOL = 1e-4    # log2-domain lse, fp32 in both from the same bf16 inputs
ADAM_TOL = 1e-6   # fused Adam u / m / v, fp32 error relative to the largest plain value
CE_TOL = 1e-4     # fused CE nll and log2-domain lse: absolute fp32, the same bf16 inputs
DB_TOL = 1e-4     # fused CE db: fp32 sums in another order, relative to the largest value
RATIO_TOL = 1e-6  # fused LAMB trust ratio, relative: fp64 sums of fp32 squares in another order
SQ_TOL = 1e-5     # E's sum of u^2, relative: fp32 partial sums in another order than the plain sum


GRAD_FLOOR = 2.0**-10   # backward rows: reference magnitude floored at this share of the max


def _ulp_err(out, ref, floor=0.0):
    """Largest |out - ref| of each row (the last axis) in bf16 ulps of the
    row's largest |ref|; the ulp of x in [2^e, 2^(e+1)) is 2^(e-7). With
    ``floor`` > 0 a row's magnitude is at least ``floor`` times the whole
    tensor's largest |ref| (as chip_smoke.py: gradient rows that cancel to
    rounding residue are measured at the tensor's scale)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs().amax(-1)
    mag = ref.abs().amax(-1).clamp(min=floor * float(ref.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / ulp).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(r, shape, dev, dtype=torch.bfloat16):
    return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("B,S,H,KV,Hd,causal,alibi,mask", [
    (1, 512, 32, 32, 128, True, False, False),     # Llama-7B prefill bucket
    (2, 300, 8, 2, 128, True, True, True),         # GQA, unaligned, ALiBi + key mask
    (2, 200, 12, 12, 64, True, False, False),      # GPT-2 heads (the TPU's packed path)
    (1, 130, 4, 1, 64, False, True, True),         # full attention
    (2, 200, 8, 2, 96, True, False, True),         # Hd 96, zero-padded to 128
])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, Hd, causal, alibi, mask):
    r = np.random.default_rng(S + H)
    q, k, v = (_randn(r, (B, S, n, Hd), cuda) for n in (H, KV, KV))
    kw = {"causal": causal}
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(r.uniform(0.05, 0.4, H).astype(np.float32)).to(cuda)
    if mask:
        keep = r.random((B, S)) > 0.2
        keep[:, 0] = True
        kw["mask_bias"] = torch.from_numpy(np.where(keep, 0.0, -1e9).astype(np.float32)).to(cuda)
    n0 = fa.launches
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ro, rlse = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    assert _ulp_err(o, ro) <= ULP_TOL
    assert float((lse - rlse).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("B,H,KV,Hd,bs,pos,bias,alibi", [
    (8, 32, 32, 128, 128, [543, 31, 127, 128, 300, 0, 511, 255], False, False),
    (3, 32, 8, 128, 128, [127, 128, 511], True, True),
    (4, 12, 12, 64, 128, [0, 255, 256, 1023], False, False),
    (2, 16, 2, 128, 256, [5, 700], True, False),
    # split boundaries (128 keys a split) and the serve's real table: n_max 32,
    # one row at its last slot (32 live splits), one at 0 (31 empty splits)
    (4, 32, 4, 128, 128, [127, 128, 255, 256], False, True),
    (8, 32, 32, 128, 128, [4095, 0, 543, 31, 128, 2047, 1000, 255], False, False),
    (2, 16, 2, 64, 256, [4095, 129], True, True),
])
def test_paged_kernel_matches_plain(cuda, B, H, KV, Hd, bs, pos, bias, alibi):
    r = np.random.default_rng(B * H + bs)
    n_max = min(max(pos) // bs + 2, 4096 // bs)     # a dead tail block, at most 4096 slots
    nb = B * n_max + 1
    kp, vp = _randn(r, (nb, bs, KV, Hd), cuda), _randn(r, (nb, bs, KV, Hd), cuda)
    q = _randn(r, (B, H, Hd), cuda)
    bt = torch.from_numpy((r.permutation(nb - 1)[:B * n_max] + 1)
                          .reshape(B, n_max).astype(np.int32)).to(cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kw = {}
    if bias:
        kw["pad_bias"] = torch.from_numpy(
            (r.normal(size=(B, n_max * bs)) * 0.2).astype(np.float32)).to(cuda)
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(r.uniform(0.05, 0.4, H).astype(np.float32)).to(cuda)
    n0 = pda.launches
    out = pda.paged_decode_attention(q, kp, vp, bt, pos_t, **kw)
    ref = pda.paged_decode_attention_plain(q, kp, vp, bt, pos_t, **kw)
    torch.cuda.synchronize()
    assert pda.launches == n0 + 1
    assert _ulp_err(out, ref) <= ULP_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("G", [1, 8])
def test_decode_kernels_repeat_bit_for_bit(cuda, dtype, G):
    """Both decode kernels merge their per-split partials in split order,
    without atomics: two launches give the same bits, at many splits."""
    r = np.random.default_rng(G)
    B, KV, Hd, bs, n_max = 4, 4, 128, 128, 16
    H = KV * G
    nb = B * n_max + 1
    kp, vp = _randn(r, (nb, bs, KV, Hd), cuda, dtype), _randn(r, (nb, bs, KV, Hd), cuda, dtype)
    q = _randn(r, (B, H, Hd), cuda, dtype)
    bt = torch.from_numpy((r.permutation(nb - 1)[:B * n_max] + 1)
                          .reshape(B, n_max).astype(np.int32)).to(cuda)
    pos = torch.tensor([2047, 0, 700, 128], dtype=torch.int32, device=cuda)
    a = pda.paged_decode_attention(q, kp, vp, bt, pos)
    b = pda.paged_decode_attention(q, kp, vp, bt, pos)
    ck, cv = _randn(r, (B, 2048, KV, Hd), cuda, dtype), _randn(r, (B, 2048, KV, Hd), cuda, dtype)
    c = dda.decode_attention(q, ck, cv, 1500)
    d = dda.decode_attention(q, ck, cv, 1500)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)
    assert _ulp_err(a, pda.paged_decode_attention_plain(q, kp, vp, bt, pos)) <= ULP_TOL
    assert _ulp_err(c, dda.decode_attention_plain(q, ck, cv, 1500)) <= ULP_TOL


def test_wrappers_raise_instead_of_falling_back(cuda):
    """On the card a wrapper launches its kernel or raises: unsupported
    dtypes, head dims and layouts never drop quietly to the plain version."""
    x = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="fp16/bf16"):
        fa.flash_attention(x, x, x)
    for hd in (100, 136):      # not a multiple of 8, and past 128
        y = torch.zeros((1, 16, 2, hd), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(y, y, y)
    z = torch.zeros((1, 2, 16, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(z, z, z)
    q = torch.zeros((1, 6, 64), device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros((2, 128, 2, 64), device=cuda, dtype=torch.bfloat16)
    bt = torch.ones((1, 1), device=cuda, dtype=torch.int32)
    pos = torch.zeros((1,), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="H/KV"):          # G = 3 is not instantiated
        pda.paged_decode_attention(q, kp, kp, bt, pos)
    with pytest.raises(TypeError, match="block_tables"):
        pda.paged_decode_attention(q[:, :2], kp, kp, bt.long(), pos)


def _attn_inputs(r, B, S, H, KV, Hd, cuda, alibi, mask, masked_row=False):
    q, k, v = (_randn(r, (B, S, n, Hd), cuda) for n in (H, KV, KV))
    kw = {}
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(r.uniform(0.05, 0.4, H).astype(np.float32)).to(cuda)
    if mask:
        keep = r.random((B, S)) > 0.2
        keep[:, 0] = True
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
        if masked_row:
            bias[-1] = -np.inf           # every key of the last batch row masked
        kw["mask_bias"] = torch.from_numpy(bias).to(cuda)
    return q, k, v, kw


@pytest.mark.parametrize("B,S,H,KV,Hd,causal,alibi,mask", [
    (2, 512, 32, 32, 128, True, False, False),     # Llama-7B heads
    (1, 200, 32, 8, 128, True, False, False),      # GQA 4, ragged S
    (2, 256, 16, 2, 128, True, True, False),       # GQA 8, ALiBi
    (2, 200, 12, 12, 64, True, False, False),      # GPT-2 heads (the TPU's packed path)
    (2, 130, 4, 1, 64, False, True, True),         # full attention, ALiBi + key mask
    (2, 192, 8, 8, 128, True, False, True),        # a fully masked batch row
    (2, 256, 8, 4, 96, True, True, False),         # Hd 96, zero-padded to 128
])
def test_flash_backward_kernels_match_plain(cuda, B, S, H, KV, Hd, causal, alibi, mask):
    """Kernels C (dq) and D (dk, dv) against their plain versions, from
    kernel A's own o and lse."""
    r = np.random.default_rng(3 * S + H + KV)
    q, k, v, kw = _attn_inputs(r, B, S, H, KV, Hd, cuda, alibi, mask, masked_row=mask and causal)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True, **kw)
    do = _randn(r, (B, S, H, Hd), cuda)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    n_dq, n_dkv = fa.dq_launches, fa.dkv_launches
    dq = fa.flash_attention_dq(*args, causal=causal, **kw)
    dk, dv = fa.flash_attention_dkv(*args, causal=causal, **kw)
    rdq = fa.flash_attention_dq_plain(*args, causal=causal, **kw)
    rdk, rdv = fa.flash_attention_dkv_plain(*args, causal=causal, **kw)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (n_dq + 1, n_dkv + 1)
    for out, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
        assert _ulp_err(out, ref, GRAD_FLOOR) <= ULP_TOL


@pytest.mark.parametrize("B,S,H,KV,Hd,causal,dtype", [
    (1, 100, 8, 8, 64, True, torch.float16),       # S below one 128-row tile
    (2, 300, 16, 4, 128, False, torch.float16),    # GQA 4, full attention, ragged S
])
def test_flash_kernels_fp16(cuda, B, S, H, KV, Hd, causal, dtype):
    """Kernels A, C and D in fp16 against their plain versions."""
    r = np.random.default_rng(S + Hd)
    q, k, v = (_randn(r, (B, S, n, Hd), cuda, dtype) for n in (H, KV, KV))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ro, rlse = fa.flash_attention_plain(q, k, v, causal=causal)
    do = _randn(r, (B, S, H, Hd), cuda, dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, causal=causal)
    rdq = fa.flash_attention_dq_plain(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal)
    rdk, rdv = fa.flash_attention_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == dq.dtype == dk.dtype == dtype
    assert _ulp_err(o, ro) <= ULP_TOL
    assert float((lse - rlse).abs().max()) <= LSE_TOL
    for out, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _ulp_err(out, ref, GRAD_FLOOR) <= ULP_TOL


@pytest.mark.parametrize("B,S,H,KV", [
    (4, 2048, 32, 32),     # the train phase's micro-batch
    (1, 200, 32, 8),       # GQA 4, ragged S
])
def test_flash_kernels_repeat_bit_for_bit(cuda, B, S, H, KV):
    """Two launches of A (o, lse), of C (dq) and of D (dk, dv) give the same
    bits: no split over keys or q tiles, no atomics."""
    r = np.random.default_rng(S + KV)
    q, k, v, _ = _attn_inputs(r, B, S, H, KV, 128, cuda, False, False)
    do = _randn(r, (B, S, H, 128), cuda)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        runs.append((o, lse, fa.flash_attention_dq(q, k, v, do, lse, delta),
                     *fa.flash_attention_dkv(q, k, v, do, lse, delta)))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def _layout(kind, H, S):
    """Block layouts of the sparse cases: the Fixed config of the train path
    at block 128 or 64, BigBird (random blocks, bidirectional), and a random
    layout at block 32 with an all-zero row block in head 0."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    if kind in ("fixed128", "fixed64"):
        return sa.FixedSparsityConfig(num_heads=H, block=int(kind[5:]), num_local_blocks=4,
                                      num_global_blocks=1,
                                      attention="unidirectional").make_layout(S)
    if kind == "bigbird128":
        return sa.BigBirdSparsityConfig(num_heads=H, block=128,
                                        different_layout_per_head=True).make_layout(S)
    r = np.random.default_rng(S)
    lay = torch.from_numpy((r.random((H, S // 32, S // 32)) > 0.6).astype(np.int64))
    lay[0, 2] = 0
    return lay


@pytest.mark.parametrize("B,S,H,KV,Hd,kind,causal,mask", [
    (1, 1024, 8, 8, 128, "fixed128", True, False),   # the train path's layout
    (2, 512, 4, 4, 128, "fixed64", True, False),     # blocks straddle A's 128-wide tiles
    (2, 384, 8, 2, 128, "bigbird128", False, False), # GQA 4, bidirectional
    (1, 320, 4, 2, 96, "random32", False, True),     # ragged S, Hd 96, a key mask, a dead row
    (2, 256, 4, 4, 64, "random32", True, False),
])
def test_flash_layout_kernels_match_plain(cuda, B, S, H, KV, Hd, kind, causal, mask):
    """A, C and D with a block layout against their layout-aware plain
    versions; rows the layout leaves no key read o = 0, lse = 1e30 and zero
    gradients."""
    r = np.random.default_rng(S + H + Hd)
    q, k, v, kw = _attn_inputs(r, B, S, H, KV, Hd, cuda, False, mask)
    kw.update(causal=causal, block_layout=_layout(kind, H, S))
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ro, rlse = fa.flash_attention_plain(q, k, v, **kw)
    do = _randn(r, (B, S, H, Hd), cuda)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dq, (dk, dv) = fa.flash_attention_dq(*args, **kw), fa.flash_attention_dkv(*args, **kw)
    rdq = fa.flash_attention_dq_plain(*args, **kw)
    rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _ulp_err(o, ro) <= ULP_TOL
    assert float((lse - rlse).abs().max()) <= LSE_TOL
    for out, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(out.float()).all()
        assert _ulp_err(out, ref, GRAD_FLOOR) <= ULP_TOL
    if kind == "random32":        # head 0's row block 2 is dead: o = 0, lse = 1e30, dq = 0
        rows = slice(64, 96)
        assert float(o[:, rows, 0].abs().max()) == 0.0 and float(dq[:, rows, 0].abs().max()) == 0.0
        assert bool((lse[:, 0, rows] == 1e30).all())


@pytest.mark.parametrize("kind,causal", [("fixed128", True), ("fixed64", True),
                                         ("bigbird128", False)])
def test_flash_layout_walks_the_live_tiles(cuda, kind, causal):
    """Each kernel's producer walks exactly its live-tile lists (the device
    counters read B times the lists' lengths), and a dense layout walks the
    same tiles in the same order as no layout: the same bits."""
    B, S, H, KV, Hd = 2, 512, 4, 2, 128
    r = np.random.default_rng(11)
    q, k, v, _ = _attn_inputs(r, B, S, H, KV, Hd, cuda, False, False)
    do = _randn(r, (B, S, H, Hd), cuda)
    lay = _layout(kind, H, S)
    keep = fa._layout_keep(lay, S, H, causal)
    want = {kern: B * len(fa.live_tiles(keep, S, causal, kern, KV)[1])
            for kern in ("fwd", "dq", "dkv")}

    def run(layout):
        o, lse = fa.flash_attention(q, k, v, causal=causal, block_layout=layout,
                                    return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        return (o, lse, fa.flash_attention_dq(*args, causal=causal, block_layout=layout),
                *fa.flash_attention_dkv(*args, causal=causal, block_layout=layout))

    fa.reset_tile_counts()
    run(lay)
    assert fa.tile_counts() == want
    dense = run(torch.ones((S // 128, S // 128), dtype=torch.int64))
    plain = run(None)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(dense, plain))


def test_flash_attention_autograd_runs_the_kernels(cuda):
    """loss.backward() through flash_attention launches A once, C and D once."""
    r = np.random.default_rng(5)
    q, k, v, _ = _attn_inputs(r, 1, 128, 8, 2, 128, cuda, False, False)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    n = (fa.launches, fa.dq_launches, fa.dkv_launches)
    fa.flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


@pytest.mark.parametrize("B,S,H,KV,Hd,causal,alibi,kind", [
    (2, 512, 32, 32, 128, True, False, None),      # Llama-7B heads
    (1, 300, 16, 4, 128, True, True, None),        # GQA 4, ALiBi, ragged S
    (2, 256, 8, 2, 64, False, False, None),        # full attention, Hd 64
    (1, 320, 4, 2, 96, False, False, "random32"),  # a layout with a dead row block, Hd 96
])
def test_flash_lse_backward_runs_the_kernels(cuda, B, S, H, KV, Hd, causal, alibi, kind):
    """return_lse=True with a gradient: one launch each of A, C and D, and
    dq, dk, dv of a loss on o and lse against the plain backward fed
    delta - log2(e) dlse; rows the layout leaves no key keep lse = 1e30 and
    dq = 0."""
    r = np.random.default_rng(7 * S + H)
    q, k, v, kw = _attn_inputs(r, B, S, H, KV, Hd, cuda, alibi, False)
    kw.update(causal=causal, block_layout=None if kind is None else _layout(kind, H, S))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    do = _randn(r, (B, S, H, Hd), cuda)
    dlse = torch.from_numpy(r.normal(size=(B, H, S)).astype(np.float32)).to(cuda)
    n = (fa.launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_attention(*leaves, return_lse=True, **kw)
    dq, dk, dv = torch.autograd.grad((o, lse), leaves, (do, dlse))
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    o, lse = o.detach(), lse.detach()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) - 1.4426950408889634 * dlse
    args = (q.detach(), k.detach(), v.detach(), do, lse, delta.contiguous())
    rdq = fa.flash_attention_dq_plain(*args, **kw)
    rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
    for out, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(out.float()).all()
        assert _ulp_err(out, ref, GRAD_FLOOR) <= ULP_TOL
    if kind == "random32":        # head 0's row block 2 is dead
        rows = slice(64, 96)
        assert bool((lse[:, 0, rows] == 1e30).all()) and float(dq[:, rows, 0].abs().max()) == 0.0


@pytest.mark.parametrize("n,p_dtype,g_dtype,emit,adam_w,wd,bc", [
    (1_000_000, torch.float32, torch.float32, "param", True, 0.1, True),    # the engine's call
    (1_000_000, torch.float32, torch.float32, "update", True, 0.1, True),
    (1000, torch.float32, torch.float32, "update", True, 0.1, True),        # ragged leaf
    (4099, torch.bfloat16, torch.bfloat16, "param", True, 0.0, True),
    (777, torch.float16, torch.float32, "param", False, 0.1, False),        # L2 Adam, no bias corr.
])
def test_fused_adam_kernel_matches_plain(cuda, n, p_dtype, g_dtype, emit, adam_w, wd, bc):
    r = np.random.default_rng(n)
    p = _randn(r, (n,), cuda, p_dtype)
    g = _randn(r, (n,), cuda, g_dtype)
    m = _randn(r, (n,), cuda, torch.float32) * 0.1
    v = _randn(r, (n,), cuda, torch.float32).square() * 0.01
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, adam_w_mode=adam_w)
    bc1, bc2 = fad.bias_corrections(3, 0.9, 0.95, bc)
    ref, rm, rv, rsq = fad.fused_adam_plain(p, g, m, v, 3e-4, bc1, bc2, emit=emit, **kw)
    n0 = fad.launches
    # emit param writes p in place, as the engine updates its masters; the
    # sq slots get the blocks' partial sums of u^2 (the sentinel's input)
    sq = torch.full((fad.adam_blocks(n),), float("nan"), device=cuda)
    out = fad.fused_adam_step(p, g, m, v, step=3, lr=3e-4, bias_correction=bc, emit=emit,
                              out=p if emit == "param" else None, sq=sq, **kw)
    torch.cuda.synchronize()
    assert fad.launches == n0 + 1
    for a, b in ((out, ref), (m, rm), (v, rv)):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= ADAM_TOL, err
    assert abs(float(sq.sum()) - float(rsq)) <= SQ_TOL * float(rsq)


def test_fused_adam_sum_of_squares_repeats_bit_for_bit(cuda):
    """E's partial sums of u^2 come from a fixed-order block reduction (no
    atomics): two launches on the same inputs write the same slots."""
    r = np.random.default_rng(5)
    base = [_randn(r, (3_000_001,), cuda, torch.float32) for _ in range(4)]
    runs = []
    for _ in range(2):
        p, g, m, v = (x.clone() for x in base)
        v.square_()
        sq = torch.empty(fad.adam_blocks(p.numel()), device=cuda)
        fad.fused_adam_step(p, g, m, v, step=2, lr=1e-3, weight_decay=0.1, out=p, sq=sq)
        runs.append(sq)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("B,H,KV,Hd,Smax,pos,bias,alibi", [
    (8, 32, 32, 128, 1024, 575, False, False),     # Llama-7B static generate
    (2, 32, 8, 128, 256, 0, True, False),          # GQA 4, first token, pad bias
    (3, 16, 2, 128, 384, 383, False, True),        # GQA 8, last slot, ALiBi
    (2, 12, 12, 64, 512, 200, True, True),         # GPT-2 heads
    (8, 32, 32, 128, 4096, 4095, False, False),    # 32 splits of 128 keys
    (2, 32, 8, 128, 512, 128, True, True),         # pos on a split boundary
    (3, 16, 16, 64, 1024, 127, False, True),       # the last key of split 0
])
def test_dense_decode_kernel_matches_plain(cuda, B, H, KV, Hd, Smax, pos, bias, alibi):
    r = np.random.default_rng(B * H + Smax + pos)
    q = _randn(r, (B, H, Hd), cuda)
    ck, cv = _randn(r, (B, Smax, KV, Hd), cuda), _randn(r, (B, Smax, KV, Hd), cuda)
    kw = {}
    if bias:
        kw["pad_bias"] = torch.from_numpy(
            (r.normal(size=(B, Smax)) * 0.2).astype(np.float32)).to(cuda)
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(r.uniform(0.05, 0.4, H).astype(np.float32)).to(cuda)
    n0 = dda.launches
    out = dda.decode_attention(q, ck, cv, pos, **kw)
    ref = dda.decode_attention_plain(q, ck, cv, pos, **kw)
    torch.cuda.synchronize()
    assert dda.launches == n0 + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert _ulp_err(out, ref) <= ULP_TOL


@pytest.mark.parametrize("G,bias,alibi,dtype", [
    (4, True, False, torch.bfloat16),
    (8, False, True, torch.bfloat16),
    (1, True, True, torch.float16),
])
def test_decode_kernels_take_head_dim_96(cuda, G, bias, alibi, dtype):
    """B and the dense decode kernel at Hd 96 (12 16-byte slices a key row,
    on 16-lane row groups) against their plain versions, and two launches
    bit-equal. The model's paths keep the JAX package's envelope (Hd a
    multiple of 64), so the kernels are called directly."""
    r = np.random.default_rng(96 + G)
    B, KV, Hd, bs, n_max = 3, 4, 96, 128, 6
    H = KV * G
    nb = B * n_max + 1
    kp, vp = _randn(r, (nb, bs, KV, Hd), cuda, dtype), _randn(r, (nb, bs, KV, Hd), cuda, dtype)
    q = _randn(r, (B, H, Hd), cuda, dtype)
    bt = torch.from_numpy((r.permutation(nb - 1)[:B * n_max] + 1)
                          .reshape(B, n_max).astype(np.int32)).to(cuda)
    pos = torch.tensor([0, 300, 767], dtype=torch.int32, device=cuda)
    ck, cv = _randn(r, (B, 512, KV, Hd), cuda, dtype), _randn(r, (B, 512, KV, Hd), cuda, dtype)
    pkw, dkw = {}, {}
    if bias:
        pkw["pad_bias"] = torch.from_numpy(
            (r.normal(size=(B, n_max * bs)) * 0.2).astype(np.float32)).to(cuda)
        dkw["pad_bias"] = pkw["pad_bias"][:, :512].contiguous()
    if alibi:
        pkw["alibi_slopes"] = dkw["alibi_slopes"] = torch.from_numpy(
            r.uniform(0.05, 0.4, H).astype(np.float32)).to(cuda)
    paged = lambda: pda.paged_decode_attention_cuda(q, kp, vp, bt, pos, **pkw)
    dense = lambda: dda.decode_attention_cuda(q, ck, cv, 400, **dkw)
    a, b, c, d = paged(), paged(), dense(), dense()
    ra = pda.paged_decode_attention_plain(q, kp, vp, bt, pos, pkw.get("pad_bias"),
                                          pkw.get("alibi_slopes"))
    rc = dda.decode_attention_plain(q, ck, cv, 400, dkw.get("pad_bias"), dkw.get("alibi_slopes"))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)
    assert _ulp_err(a, ra) <= ULP_TOL and _ulp_err(c, rc) <= ULP_TOL


def _ce_inputs(r, N, D, V, cuda, bias, tied, dtype=torch.bfloat16):
    h = _randn(r, (N, D), cuda, dtype)
    if tied:
        w = (_randn(r, (V, D), cuda).float() * 0.05).to(dtype).T   # embed.T, in place
    else:
        w = (_randn(r, (D, V), cuda).float() * 0.05).to(dtype)
    b = torch.from_numpy((r.normal(size=V) * 0.5).astype(np.float32)).to(cuda) if bias else None
    labels = torch.from_numpy(r.integers(0, V, size=N).astype(np.int32)).to(cuda)
    return h, w, b, labels


@pytest.mark.parametrize("N,D,V,bias,tied", [
    (1000, 512, 32000, False, False),      # Llama's vocab, N off the tile
    (300, 768, 50257, True, True),         # GPT-2: V off the tile, tied embed.T, a bias
    (130, 256, 1000, True, False),         # untied with a bias
    (1000, 768, 50257, True, False),       # untied V = 50257: W copied into padded rows
    (1000, 776, 1000, False, False),       # K % 64 != 0 in all three products; M, N ragged
    (257, 776, 1000, False, True),         # the same, tied (B K-major in G, MN-major in dh)
    (200, 100, 1000, True, True),          # D % 8 != 0: h and the tied W copied
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_ce_kernels_match_plain(cuda, N, D, V, bias, tied, dtype):
    """F, G and both products against their plain versions."""
    r = np.random.default_rng(N + V)
    h, w, b, labels = _ce_inputs(r, N, D, V, cuda, bias, tied, dtype)
    counts = (fce.fwd_launches, fce.ds_launches, fce.dh_launches, fce.dw_launches)
    nll, lse = fce.fused_ce_fwd(h, w, b, labels)
    rnll, rlse = fce.fused_ce_fwd_plain(h, w, b, labels)
    coef = torch.from_numpy(r.uniform(0, 2e-3, N).astype(np.float32)).to(cuda)
    coef[::7] = 0.0                         # masked tokens
    ds, db = fce.fused_ce_ds(h, w, b, labels, rlse, coef)
    rds, rdb = fce.fused_ce_ds_plain(h, w, b, labels, rlse, coef)
    dh, dw = fce.fused_ce_dh(rds, w), fce.fused_ce_dw(h, rds, w)
    rdh, rdw = fce.fused_ce_dh_plain(rds, w), fce.fused_ce_dw_plain(h, rds)
    torch.cuda.synchronize()
    assert (fce.fwd_launches, fce.ds_launches, fce.dh_launches, fce.dw_launches) == tuple(
        c + 1 for c in counts)
    assert float((lse - rlse).abs().max()) <= CE_TOL
    assert float((nll - rnll).abs().max()) <= CE_TOL
    assert ds.shape == (N, V) and _ulp_err(ds, rds, GRAD_FLOOR) <= ULP_TOL
    if dtype == torch.bfloat16:
        # the softmax part alone (a row's ulp is otherwise its gold entry's);
        # in fp16 it lies in subnormals at these V (coef p < 6.1e-5)
        gold = torch.zeros((N, V), dtype=torch.bool, device=cuda)
        gold[torch.arange(N, device=cuda), labels.long()] = True
        assert _ulp_err(ds.float().masked_fill(gold, 0), rds.float().masked_fill(gold, 0),
                        GRAD_FLOOR) <= ULP_TOL
    assert dh.shape == (N, D) and _ulp_err(dh, rdh, GRAD_FLOOR) <= ULP_TOL
    assert dw.shape == (D, V) and _ulp_err(dw, rdw, GRAD_FLOOR) <= ULP_TOL
    if bias:
        assert float((db - rdb).abs().max() / rdb.abs().max()) <= DB_TOL
    else:
        assert db is None


@pytest.mark.parametrize("tied", [False, True])
def test_fused_ce_backward_kernels_repeat_bit_for_bit(cuda, tied):
    """Two launches of G, dh and dW give the same bits (no split-K, no
    atomics: every output element is one fp32 sum in a fixed order)."""
    r = np.random.default_rng(11)
    N, D, V = 1000, 776, 1000
    h, w, b, labels = _ce_inputs(r, N, D, V, cuda, True, tied)
    _, lse = fce.fused_ce_fwd_plain(h, w, b, labels)
    coef = torch.full((N,), 1.0 / N, device=cuda)
    outs = []
    for _ in range(2):
        ds, db = fce.fused_ce_ds(h, w, b, labels, lse, coef)
        outs.append((ds, db, fce.fused_ce_dh(ds, w), fce.fused_ce_dw(h, ds, w)))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.parametrize("N,D,V,bias,tied", [
    (8192, 512, 32000, False, False),       # the train micro-batch's tokens, Llama's vocab
    (1000, 768, 50257, True, True),         # GPT-2's tied head with a bias
])
def test_fused_ce_fwd_repeats_bit_for_bit(cuda, N, D, V, bias, tied):
    """Two launches of F (and its combine) give the same bits: each (token,
    vocab tile) partial is written once and combined in tile order."""
    r = np.random.default_rng(N + D)
    h, w, b, labels = _ce_inputs(r, N, D, V, cuda, bias, tied)
    first = fce.fused_ce_fwd(h, w, b, labels)
    second = fce.fused_ce_fwd(h, w, b, labels)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_fused_cross_entropy_autograd_runs_the_kernels(cuda):
    """loss.backward() through fused_cross_entropy launches F once, G and
    each product once, and gives finite gradients for h, a tied W and b."""
    r = np.random.default_rng(9)
    h, w, b, labels = _ce_inputs(r, 256, 256, 2000, cuda, True, True)
    embed = w.T.detach().clone().requires_grad_()
    h, b = h.requires_grad_(), b.requires_grad_()
    valid = torch.ones(256, device=cuda)
    valid[:10] = 0
    n = (fce.fwd_launches, fce.ds_launches, fce.dh_launches, fce.dw_launches)
    fce.fused_cross_entropy(h, embed.T, labels, bias=b, valid=valid).backward()
    torch.cuda.synchronize()
    assert (fce.fwd_launches, fce.ds_launches, fce.dh_launches, fce.dw_launches) == tuple(
        c + 1 for c in n)
    assert all(torch.isfinite(x.grad.float()).all() for x in (h, embed, b))
    with pytest.raises(TypeError, match="fp16/bf16"):
        fce.fused_cross_entropy(h.detach().float(), embed.detach().T.float(), labels)


@pytest.mark.parametrize("L,n,p_dtype,g_dtype,wd,bc", [
    (1, 1_000_000, torch.float32, torch.float32, 0.01, True),    # one leaf, the engine's call
    (3, 4099, torch.float32, torch.bfloat16, 0.01, True),        # ragged leaves, bf16 grads
    (8, 65536, torch.float32, torch.float32, 0.0, False),        # a stacked group, no decay
    (2, 777, torch.bfloat16, torch.float32, 0.01, True),         # bf16 params
])
def test_fused_lamb_kernels_match_plain(cuda, L, n, p_dtype, g_dtype, wd, bc):
    """K7 over a group of L leaves (moments, one ratio, apply) against the
    plain version of the same group: p, m, v within ADAM_TOL of their largest
    value, the ratio within RATIO_TOL; launches L + 1 + L."""
    r = np.random.default_rng(L * n)
    ps = [_randn(r, (n,), cuda, torch.float32).mul_(0.02).to(p_dtype) for _ in range(L)]
    gs = [_randn(r, (n,), cuda, torch.float32).mul_(1e-3).to(g_dtype) for _ in range(L)]
    ms = [_randn(r, (n,), cuda, torch.float32).mul_(1e-4) for _ in range(L)]
    vs = [_randn(r, (n,), cuda, torch.float32).square_().mul_(1e-7) for _ in range(L)]
    kw = dict(step=3, lr=1e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=wd, bias_correction=bc)
    cpu = lambda xs: [x.cpu().clone() for x in xs]
    rp, rm, rv = cpu(ps), cpu(ms), cpu(vs)
    want_unorm, unorm = torch.zeros(1), torch.zeros(1, device=cuda)
    want = fl.lamb_group_step(rp, cpu(gs), rm, rv, unorm=want_unorm, **kw)
    n0 = (fl.moments_launches, fl.ratio_launches, fl.apply_launches)
    ratio = fl.lamb_group_step(ps, gs, ms, vs, unorm=unorm, **kw)
    torch.cuda.synchronize()
    assert (fl.moments_launches, fl.ratio_launches, fl.apply_launches) == (
        n0[0] + L, n0[1] + 1, n0[2] + L)
    assert abs(float(ratio) - float(want)) <= RATIO_TOL * float(want)
    # ratio * ||u||, the group's applied direction's norm (update norm / lr)
    assert abs(float(unorm) - float(want_unorm)) <= RATIO_TOL * float(want_unorm)
    for got, ref in ((ps, rp), (ms, rm), (vs, rv)):
        a, b = torch.cat([x.float().cpu() for x in got]), torch.cat([x.float() for x in ref])
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= (ADAM_TOL if p_dtype == torch.float32 or got is not ps else 2**-8), err


def test_fused_lamb_repeats_bit_for_bit(cuda):
    r = np.random.default_rng(3)
    base = [_randn(r, (300_000,), cuda, torch.float32) for _ in range(4)]
    runs = []
    for _ in range(2):
        p, g, m, v = (x.clone() for x in base)
        v.square_()
        ratio = fl.lamb_group_step([p], [g], [m], [v], step=1, lr=1e-3, weight_decay=0.01)
        runs.append((ratio, p, m, v))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _sr_leaves(x, views):
    """The leaves ``x[i]``: each its own allocation, or (``views``) carved
    out of one buffer at odd element offsets, so their addresses sit off
    16-byte boundaries."""
    if not views:
        return [x[i].clone() for i in range(x.shape[0])]
    n = x[0].numel()
    buf = torch.zeros(x.numel() + 2 * x.shape[0] + 1, dtype=x.dtype, device=x.device)
    leaves = []
    for i in range(x.shape[0]):
        at = 3 + i * (n + 1)
        leaves.append(buf[at:at + n].view(x[i].shape).copy_(x[i]))
    return leaves


@pytest.mark.parametrize("shape,groups,bits,dtype,views", [
    ((4096, 512), 64, 8, torch.bfloat16, False),     # one leaf, 64 groups
    ((3, 1000, 7), 3, 8, torch.bfloat16, False),     # a group per leaf, leaves of 7000 (not 8-aligned)
    ((2, 96, 10), 3, 4, torch.float32, False),       # 3 groups over 2 leaves: group 1 spans both
    ((1, 1001), 7, 16, torch.float16, False),
    ((5, 3, 1001), 1365, 8, torch.bfloat16, True),   # odd offsets and addresses, 11-element groups
    ((3, 777, 11), 7, 8, torch.float32, True),       # groups of 3663 spanning leaves
    ((4, 1003), 4, 16, torch.float16, True),
])
def test_sr_quantize_kernel_matches_plain_with_its_noise(cuda, shape, groups, bits, dtype, views):
    """K8 on the leaves of a stacked tensor, one launch per leaf with its
    offset, against the plain version fed the kernel's own Philox noise:
    equal bit for bit out of place and in place (leaves at odd addresses
    take the one-element path out of place and the vector path with a lead
    in place); the absmax kernel's scales equal the plain scale pass's; a
    seed repeats and another moves."""
    r = np.random.default_rng(bits + groups)
    x = _randn(r, shape, cuda, dtype)
    leaves = _sr_leaves(x, views)
    flat = x.reshape(groups, -1).float()
    plain_scale = qk._sym_scale(flat, bits)[0]
    noise = qk.philox_uniform(17, 0, x.numel(), device=cuda).reshape(groups, -1)
    want = qk.sr_quantize_plain(flat, plain_scale, 2.0 ** (bits - 1) - 1,
                                noise).to(dtype).reshape(shape)
    n0, s0 = qk.launches, qk.scale_launches
    got = qk.ds_sr_quantize_span(leaves, groups, bits, seed=17)
    torch.cuda.synchronize()
    assert (qk.launches, qk.scale_launches) == (n0 + len(leaves), s0 + len(leaves))
    assert torch.equal(torch.stack(got), want)
    scale = qk.span_scales(leaves, groups, bits)[0]
    assert torch.equal(scale, plain_scale.reshape(-1))
    assert torch.equal(scale, qk._span_scales(leaves, groups, bits)[0])
    assert torch.equal(scale, qk.span_scales(leaves, groups, bits)[0])
    again = qk.ds_sr_quantize_span(leaves, groups, bits, seed=17)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    other = qk.ds_sr_quantize_span(leaves, groups, bits, seed=18)
    assert not all(torch.equal(a, b) for a, b in zip(got, other))
    qk.ds_sr_quantize_span(leaves, groups, bits, seed=17, out=leaves)      # in place
    assert torch.equal(torch.stack(leaves), want)


@pytest.mark.parametrize("form", ["sym", "asym", "span_plain", "span_kernel"])
@pytest.mark.parametrize("bits", [8, 14, 16])                  # qmax 127, 8191, 32767
def test_card_scales_divide_as_numpy_does(cuda, bits, form):
    """The port's group scales on the card are ``amax / qmax`` (symmetric)
    and ``(max - min) / levels`` (asymmetric) correctly rounded in fp32, as
    numpy and the JAX package divide, for 4096 random amax values: no
    multiplication by a reciprocal."""
    r = np.random.default_rng(bits)
    G, L = 4096, 16
    amax = (r.uniform(0.5, 1.0, G) * 2.0 ** r.integers(-20, 20, G)).astype(np.float32)
    x = (r.uniform(-1.0, 1.0, (G, L)) * amax[:, None]).astype(np.float32)
    x[np.arange(G), r.integers(0, L, G)] = amax * r.choice([-1.0, 1.0], G).astype(np.float32)
    qmax, levels = np.float32(2 ** (bits - 1) - 1), np.float32(2 ** bits - 1)
    xt = torch.from_numpy(x).to(cuda)
    leaves = [xt.reshape(-1)[:1000 * L + 5], xt.reshape(-1)[1000 * L + 5:]]   # a group spans both
    if form == "asym":
        got = qk._asym_scale(xt, bits)[0].reshape(-1)
        want = (x.max(axis=1) - x.min(axis=1)) / levels
    else:
        got = {"sym": lambda: qk._sym_scale(xt, bits)[0].reshape(-1),
               "span_plain": lambda: qk._span_scales(leaves, G, bits)[0],
               "span_kernel": lambda: qk.span_scales(leaves, G, bits)[0]}[form]()
        want = np.abs(x).max(axis=1) / qmax
    assert want.dtype == np.float32
    assert np.array_equal(got.cpu().numpy(), want)


def test_sr_quantize_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="noise"):
        qk.ds_sr_quantize(x, 4, noise=torch.zeros(4, 16, device=cuda))
    with pytest.raises(TypeError, match="fp16 / bf16 / fp32"):
        qk.ds_sr_quantize(x.double(), 4)
