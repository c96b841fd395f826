"""The port's fused cross-entropy (K3: the plain versions of F, G and the
dh / dW products behind ``fused_cross_entropy``) against the JAX package's
Pallas kernels in interpret mode: the loss and its gradients in h, W and the
bias, with a ``valid`` mask, ragged N and V (off both packages' tiles), a
bias present and absent, and a tied head (W = embed.T, the gradient taken in
embed). fp32: loss within 1e-5 relative, each gradient within 1e-5 of its
largest value (fp32 sums in other orders). bf16: the same within 2^-7 of
each gradient's largest value (one bf16 ulp at the top of the range: ds and
the outputs round at the same points). F's schedule (per-256-column-tile
partials, then the combine in tile order) is held to the plain forward and
to the JAX forward at 1e-5 absolute in fp32. Also the dispatch of
``vocab_head_ce`` by ``fused_cross_entropy`` auto / on / off, and the
operands the TMA kernels read."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_cross_entropy import fused_cross_entropy as jax_fce
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LOSS_TOL = 1e-5
GRAD_TOL = {"fp32": 1e-5, "bf16": 2.0**-7}


def _inputs(seed, N, D, V, bias, masked):
    r = np.random.default_rng(seed)
    h = r.normal(size=(N, D)).astype(np.float32)
    w = (r.normal(size=(D, V)) * 0.1).astype(np.float32)
    b = (r.normal(size=V) * 0.5).astype(np.float32) if bias else None
    labels = r.integers(0, V, size=N).astype(np.int32)
    valid = (r.random(N) > 0.3) if masked else None
    return h, w, b, labels, valid


def _jax(h, w, b, labels, valid, tied, dtype):
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    args = [jnp.asarray(h, jd), jnp.asarray(w.T if tied else w, jd)]
    if b is not None:
        args.append(jnp.asarray(b))

    def loss(hh, ww, bb=None):
        return jax_fce(hh, ww.T if tied else ww, jnp.asarray(labels), bias=bb,
                       valid=None if valid is None else jnp.asarray(valid), interpret=True)
    val, grads = jax.value_and_grad(loss, argnums=tuple(range(len(args))))(*args)
    return float(val), [np.asarray(jnp.asarray(g, jnp.float32)) for g in grads]


def _port(h, w, b, labels, valid, tied, dtype):
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    wm = np.ascontiguousarray(w.T if tied else w)          # tied: the [V, D] embedding
    leaves = [torch.from_numpy(h).to(td), torch.from_numpy(wm).to(td)]
    if b is not None:
        leaves.append(torch.from_numpy(b))
    leaves = [x.requires_grad_() for x in leaves]
    loss = fce.fused_cross_entropy(
        leaves[0], leaves[1].T if tied else leaves[1], torch.from_numpy(labels),
        bias=leaves[2] if b is not None else None,
        valid=None if valid is None else torch.from_numpy(valid))
    loss.backward()
    return float(loss.detach()), [x.grad.float().numpy() for x in leaves]


@pytest.mark.parametrize("N,D,V,bias,masked,tied", [
    (64, 32, 256, False, False, False),
    (37, 48, 300, True, True, False),       # ragged N and V, bias, valid mask
    (50, 32, 129, False, True, True),       # tied embed.T
    (130, 64, 515, True, False, True),      # tied with a bias, N over one 128 tile
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_loss_and_grads_match_jax_kernels(N, D, V, bias, masked, tied, dtype):
    h, w, b, labels, valid = _inputs(N + V, N, D, V, bias, masked)
    want, wgrads = _jax(h, w, b, labels, valid, tied, dtype)
    got, pgrads = _port(h, w, b, labels, valid, tied, dtype)
    assert got == pytest.approx(want, rel=LOSS_TOL if dtype == "fp32" else 2e-3)
    assert len(pgrads) == len(wgrads)
    for name, a, e in zip(("h", "w", "bias"), pgrads, wgrads):
        assert a.shape == e.shape, name
        err = np.abs(a - e).max() / np.abs(e).max()
        assert err <= GRAD_TOL[dtype], (name, err)


def test_empty_mask_gives_zero_loss_and_grads():
    h, w, b, labels, _ = _inputs(1, 16, 8, 40, True, False)
    valid = np.zeros(16, bool)
    got, grads = _port(h, w, b, labels, valid, False, "fp32")
    assert got == 0.0 and all(np.abs(g).max() == 0 for g in grads)


@pytest.mark.parametrize("N,D,V,bias", [
    (37, 16, 1000, True),                   # ragged V: 4 tiles, the last 232 wide
    (24, 16, 50257, True),                  # GPT-2's vocab: 197 tiles, the last 81 wide
    (64, 32, 256, False),                   # one whole tile, no bias
])
def test_fwd_tile_schedule_matches_plain_and_jax(N, D, V, bias):
    """F's schedule in plain PyTorch (the partials of each 256-wide vocab
    tile, combined in tile order) against the plain forward per token, and
    its masked mean against the JAX kernel's forward in interpret mode, all
    within 1e-5 absolute in fp32."""
    h, w, b, labels, valid = _inputs(N + V, N, D, V, bias, True)
    th, tw, tl = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels)
    tb = torch.from_numpy(b) if bias else None
    part = fce.fused_ce_fwd_tiles_plain(th, tw, tb, tl)
    assert part.shape == (3, -(-V // 256), N)
    nll, lse = fce.fused_ce_combine_plain(part)
    rnll, rlse = fce.fused_ce_fwd_plain(th, tw, tb, tl)
    torch.testing.assert_close(nll, rnll, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)
    vf = torch.from_numpy(valid.astype(np.float32))
    got = float((nll * vf).sum() / vf.sum().clamp(min=1))
    want = float(jax_fce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                         bias=None if b is None else jnp.asarray(b), valid=jnp.asarray(valid),
                         interpret=True))
    assert abs(got - want) <= 1e-5


def test_pieces_match_a_dense_reference():
    """F's nll / lse and G's ds / db against logits formed in full."""
    h, w, b, labels, _ = _inputs(2, 20, 16, 70, True, False)
    th, tw, tb, tl = (torch.from_numpy(x) for x in (h, w, b, labels))
    logits = th @ tw + tb
    nll, lse = fce.fused_ce_fwd(th, tw, tb, tl)
    ref = torch.nn.functional.cross_entropy(logits, tl.long(), reduction="none")
    torch.testing.assert_close(nll, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1) * fce._LOG2E, atol=1e-5, rtol=0)
    coef = torch.full((20,), 0.05)
    ds, db = fce.fused_ce_ds(th, tw, tb, tl, lse, coef)
    want = (torch.softmax(logits, -1) - torch.nn.functional.one_hot(tl.long(), 70)) * 0.05
    torch.testing.assert_close(ds, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(db, want.sum(0), atol=1e-6, rtol=0)
    torch.testing.assert_close(fce.fused_ce_dh(ds, tw), ds @ tw.T)
    torch.testing.assert_close(fce.fused_ce_dw(th, ds, tw), th.T @ ds)


LLAMA = dict(vocab_size=96, max_seq=32, n_layer=1, n_head=2, d_model=32, d_ff=64,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False)


def test_vocab_head_dispatch():
    """"on" runs K3 (its plain version on the CPU) and agrees with "off"
    (the chunked plain path); "auto" takes the plain path on the CPU, as
    the JAX package does off-TPU; other values raise."""
    cfg = PT.TransformerConfig(**LLAMA)
    r = np.random.default_rng(3)
    h = torch.from_numpy(r.normal(size=(2, 16, 32)).astype(np.float32))
    assert not PT._use_fused_ce(cfg, h)
    assert PT._use_fused_ce(dataclasses.replace(cfg, fused_cross_entropy="on"), h)
    assert not PT._use_fused_ce(dataclasses.replace(cfg, fused_cross_entropy="off"), h)
    with pytest.raises(ValueError, match="fused_cross_entropy"):
        PT._use_fused_ce(dataclasses.replace(cfg, fused_cross_entropy="maybe"), h)
    w = torch.from_numpy((r.normal(size=(32, 96)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, 96, size=(2, 16)))
    valid = labels % 5 != 0
    calls = fce.fwd_launches
    on = PT.vocab_head_ce(dataclasses.replace(cfg, fused_cross_entropy="on"), h, w, 0, labels,
                          valid)
    off = PT.vocab_head_ce(cfg, h, w, 0, labels, valid)
    assert fce.fwd_launches == calls            # the CPU never counts a kernel launch
    torch.testing.assert_close(on, off, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------- #
# The operands of G, dh and dW as their TMA + wgmma kernels read them: which
# is K- or MN-major for an untied and a tied W, when the wrapper copies one
# into padded rows, and that the products read from those operands equal the
# plain versions (exactly: both are fp32 sums of the same bf16 products).


def _bf16(r, shape, scale=1.0):
    return torch.from_numpy((r.normal(size=shape) * scale).astype(np.float32)).to(torch.bfloat16)


def _head(r, D, V, tied):
    """W ``[D, V]``; tied: the transpose of a ``[V, D]`` embedding."""
    return _bf16(r, (V, D), 0.05).T if tied else _bf16(r, (D, V), 0.05)


def _operands(product, h, w, ds):
    if product in ("fwd", "ds"):
        return fce.ds_operands(h, w)
    if product == "dh":
        return fce.dh_operands(ds, w)
    return fce.dw_operands(h, ds, w)[:2]


def _planned_product(a, b):
    """``A @ B`` in fp32 from the operands' rows: a K-major A is stored
    ``[M, K]``, an MN-major one ``[K, M]``; a K-major B ``[N, K]``, an
    MN-major one ``[K, N]``."""
    am = a.rows if a.major == "K" else a.rows.T
    bm = b.rows.T if b.major == "K" else b.rows
    return am.float() @ bm.float()


def _plain_product(product, h, w, ds, tied):
    """The plain versions' products in fp32: F's and G's logits
    (``_log2_logits`` without bias and log2e), ``fused_ce_dh_plain`` and
    ``fused_ce_dw_plain`` before their cast."""
    if product in ("fwd", "ds"):
        return h.float() @ w.float()
    if product == "dh":
        return ds.float() @ w.float().T
    dw = h.float().T @ ds.float()
    return dw.T if tied else dw             # a tied head's kernel writes dE = dW^T


@pytest.mark.parametrize("product,tied,want", [
    ("fwd", False, ("K", "MN")),            # F reads the logits' operands as G does
    ("fwd", True, ("K", "K")),
    ("ds", False, ("K", "MN")),             # h [N, D]; W [D, V] has V along its rows
    ("ds", True, ("K", "K")),               # the tied W's memory is [V, D]: D along its rows
    ("dh", False, ("K", "K")),              # ds [N, V]; W^T's memory [D, V] = [N, K]
    ("dh", True, ("K", "MN")),              # W^T's memory [V, D] = [K, N]
    ("dw", False, ("MN", "MN")),            # h^T from h [N, D] = [K, M]; ds [N, V] = [K, N]
    ("dw", True, ("MN", "MN")),             # dE = ds^T h: ds = [K, M], h = [K, N]
])
def test_tma_operands_are_read_as_stored(product, tied, want):
    r = np.random.default_rng(5)
    N, D, V = 40, 64, 96
    h, w, ds = _bf16(r, (N, D)), _head(r, D, V, tied), _bf16(r, (N, V), 1e-3)
    a, b = _operands(product, h, w, ds)
    assert (a.major, b.major) == want
    stored = {"fwd": (h, w), "ds": (h, w), "dh": (ds, w),
              "dw": (ds, h) if tied else (h, ds)}[product]
    assert [x.rows.data_ptr() for x in (a, b)] == [x.data_ptr() for x in stored]   # in place
    assert product != "dw" or fce.dw_operands(h, ds, w)[2] == tied
    torch.testing.assert_close(_planned_product(a, b), _plain_product(product, h, w, ds, tied))


# (N, D, V, tied, ds as G writes it, misaligned h) -> which operands of
# (G, dh, dW) are copied into padded rows, as (A, B) pairs
@pytest.mark.parametrize("N,D,V,tied,ds_padded,h_offset,copied", [
    (40, 64, 101, False, False, 0, {"ds": (0, 1), "dh": (1, 1), "dw": (0, 1)}),   # V odd: W, ds
    (40, 64, 101, False, True, 0, {"ds": (0, 1), "dh": (0, 1), "dw": (0, 0)}),    # G's ds in place
    (40, 60, 96, True, False, 0, {"ds": (1, 1), "dh": (0, 1), "dw": (0, 1)}),     # D % 8: h, embed
    (40, 60, 96, False, False, 0, {"ds": (1, 0), "dh": (0, 0), "dw": (1, 0)}),    # D % 8: h only
    (40, 64, 96, False, False, 1, {"ds": (1, 0), "dh": (0, 0), "dw": (1, 0)}),    # h's base 2 B off
])
def test_tma_operands_copy_unaligned_rows_once(N, D, V, tied, ds_padded, h_offset, copied):
    r = np.random.default_rng(N + D + V)
    h = torch.empty(N * D + h_offset, dtype=torch.bfloat16)[h_offset:].view(N, D)
    h.copy_(_bf16(r, (N, D)))
    w = _head(r, D, V, tied)
    ds = _bf16(r, (N, V), 1e-3)
    if ds_padded:                           # as G returns it: a view of [N, V rounded up to 8]
        ds = torch.zeros((N, -(-V // 8) * 8), dtype=torch.bfloat16)[:, :V].copy_(ds)
    stored = {"ds": (h, w), "dh": (ds, w), "dw": (ds, h) if tied else (h, ds)}
    for product, want in copied.items():
        ops = _operands(product, h, w, ds)
        for op, x, copy in zip(ops, stored[product], want):
            assert op.ld % 8 == 0 and op.rows.data_ptr() % 16 == 0 and op.rows.stride(1) == 1
            assert op.ld == (-(-op.rows.shape[1] // 8) * 8 if copy else op.ld)
            assert (op.rows.data_ptr() != x.data_ptr()) == bool(copy), (product, x.shape)
        torch.testing.assert_close(_planned_product(*ops), _plain_product(product, h, w, ds, tied))


@pytest.mark.parametrize("D,V,tied,h_copied,w_copied", [
    (64, 96, False, False, False),          # Llama-like: everything read in place
    (64, 101, False, False, True),          # an untied W with V odd
    (60, 96, True, True, True),             # D % 8: h and the tied embedding
    (64, 101, True, False, False),          # a tied head with V odd: its rows are D long
])
def test_tma_ready_copies_once_and_keeps_shapes(D, V, tied, h_copied, w_copied):
    """What the autograd Function hands F and the backward on the card: h
    and W as TMA reads them in place (each copied at most once, here), with
    their shapes and values, W still ``[D, V]`` and still tied or not."""
    r = np.random.default_rng(D + V)
    N = 40
    h, w = _bf16(r, (N, D)), _head(r, D, V, tied)
    h2, w2 = fce.tma_ready(h, w)
    assert (h2.data_ptr() != h.data_ptr(), w2.data_ptr() != w.data_ptr()) == (h_copied, w_copied)
    assert h2.shape == h.shape and w2.shape == w.shape and torch.equal(h2, h) and torch.equal(w2, w)
    assert fce._weight_rows(w2)[1] == tied
    for op in fce.ds_operands(h2, w2):      # F and G now read both in place
        assert op.ld % 8 == 0 and op.rows.stride(1) == 1
    assert [op.rows.data_ptr() for op in fce.ds_operands(h2, w2)] == [
        h2.data_ptr(), w2.data_ptr()]
    nll, lse = fce.fused_ce_fwd(h2, w2, None, torch.zeros(N, dtype=torch.int32))
    rnll, rlse = fce.fused_ce_fwd_plain(h, w, None, torch.zeros(N, dtype=torch.int32))
    assert torch.equal(nll, rnll) and torch.equal(lse, rlse)
