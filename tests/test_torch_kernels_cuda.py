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
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

ULP_TOL = 3.0     # bf16 ulps of each output row's largest value (as chip_smoke.py)
LSE_TOL = 1e-4    # log2-domain lse, fp32 in both from the same bf16 inputs
ADAM_TOL = 1e-6   # fused Adam u / m / v, fp32 error relative to the largest plain value


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
])
def test_paged_kernel_matches_plain(cuda, B, H, KV, Hd, bs, pos, bias, alibi):
    r = np.random.default_rng(B * H + bs)
    n_max = max(pos) // bs + 2
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


def test_wrappers_raise_instead_of_falling_back(cuda):
    """On the card a wrapper launches its kernel or raises: unsupported
    dtypes, head dims and layouts never drop quietly to the plain version."""
    x = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="fp16/bf16"):
        fa.flash_attention(x, x, x)
    y = torch.zeros((1, 16, 2, 96), device=cuda, dtype=torch.bfloat16)
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
    ref, rm, rv = fad.fused_adam_plain(p, g, m, v, 3e-4, bc1, bc2, emit=emit, **kw)
    n0 = fad.launches
    # emit param writes p in place, as the engine updates its masters
    out = fad.fused_adam_step(p, g, m, v, step=3, lr=3e-4, bias_correction=bc, emit=emit,
                              out=p if emit == "param" else None, **kw)
    torch.cuda.synchronize()
    assert fad.launches == n0 + 1
    for a, b in ((out, ref), (m, rm), (v, rv)):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= ADAM_TOL, err
