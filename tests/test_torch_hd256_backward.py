"""The flash-attention backward at head dim 256 (GPT-J's heads) against the
JAX package's.

The port's plain dq / dk / dv (the math kernels C and D run on the card at
Hd 256) from its forward's o and lse, against ``jax.grad`` through the JAX
package's Pallas kernels (``_dq_kernel`` / ``_dkv_kernel``) in interpret
mode: causal MHA, GQA with ALiBi and a key mask, full attention, an lse
cotangent (``return_lse=True``) and a block layout. Same seeded numpy
inputs, fp32; each gradient within 1e-5 of its largest value (the fp32 sums
run in other orders). Then a tiny GPT-J-shaped ``CausalLM`` (2 layers, 2
heads x 256, rotary 64 interleaved, parallel residual, untied head with its
bias) with ``attention_backend="flash"``: its loss and every leaf's
gradient against the JAX model's from the same weights
(``params_from_jax``), and three engine steps' losses and the parameters
they leave. A gradient at 256 on
the CPU goes through the plain versions (no kernel launch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TOL = 1e-5          # each gradient, relative to its largest |value| (fp32, other sum orders)
LOSS_TOL = 1e-5     # the model's loss, relative
LEAF_TOL = 3e-5     # each leaf's gradient, max |port - jax| / max |jax| (tests/test_torch_training.py)
# each leaf after 3 Adam steps: max |port - jax| / max |jax's change of it|.
# Adam moves an entry by about lr whatever its gradient's size, so an entry
# whose gradient is near zero moves with the rounding noise of the two
# packages' sums (worst 0.012, lm_head); an update missed or misscaled reads
# near 1.
STEP_TOL = 0.05
GPTJ = dict(vocab_size=64, max_seq=64, n_layer=2, n_head=2, d_model=512, d_ff=256,
            pos_embedding="rope", rope_dim=64, rope_interleaved=True, norm="layernorm",
            activation="gelu", parallel_residual=True, tie_embeddings=False, attn_bias=False,
            lm_head_bias=True, attention_backend="flash")

# (B, S, H, KV, causal, alibi, mask, lse cotangent, layout)
CASES = {
    "mha_causal": (1, 48, 2, 2, True, False, False, False, None),
    "gqa2_alibi_mask": (2, 40, 4, 2, True, True, True, False, None),
    "full_mask_gqa4": (1, 33, 4, 1, False, False, True, False, None),
    "lse_cotangent": (1, 48, 2, 1, True, False, False, True, None),
    "layout_lse": (1, 64, 2, 2, True, False, False, True, "random16"),
    "layout_full": (1, 64, 2, 1, False, False, False, False, "random16"),
}


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_at_hd256_matches_jax_grad(name):
    B, S, H, KV, causal, alibi, mask, with_lse, layout = CASES[name]
    Hd = 256
    r = np.random.default_rng(256 + sorted(CASES).index(name))
    q = r.normal(size=(B, S, H, Hd)).astype(np.float32)
    k = r.normal(size=(B, S, KV, Hd)).astype(np.float32)
    v = r.normal(size=(B, S, KV, Hd)).astype(np.float32)
    go = r.normal(size=(B, S, H, Hd)).astype(np.float32)
    glse = r.normal(size=(B, H, S)).astype(np.float32) if with_lse else None
    slopes = r.uniform(0.05, 0.4, size=H).astype(np.float32) if alibi else None
    bias = None
    if mask:
        keep = r.random((B, S)) > 0.25
        keep[:, 0] = True
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    lay = None
    if layout is not None:
        lay = (r.random((H, S // 16, S // 16)) > 0.5).astype(np.int64)
        lay[:, :, 0] = 1
    kw = dict(mask_bias=bias, causal=causal, alibi_slopes=slopes, block_layout=lay)

    def f(q_, k_, v_):
        o, lse = jax_flash(q_, k_, v_, **{n: _j(x) if n != "causal" else x
                                          for n, x in kw.items()},
                           interpret=True, return_lse=True)
        loss = jnp.sum(o * _j(go))
        return loss + jnp.sum(lse * _j(glse)) if with_lse else loss

    want = jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    pkw = {n: _t(x) if n != "causal" else x for n, x in kw.items()}
    # the kernels' math directly: dq and dk / dv from the forward's o and
    # lse, the lse cotangent folded into the row term
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), **pkw)
    delta = (_t(go) * o).sum(-1).transpose(1, 2)
    if with_lse:
        delta = delta - 1.4426950408889634 * _t(glse)
    args = (_t(q), _t(k), _t(v), _t(go), lse, delta.contiguous())
    dq = fa.flash_attention_dq_plain(*args, **pkw)
    dk, dv = fa.flash_attention_dkv_plain(*args, **pkw)
    assert dq.shape == (B, S, H, Hd) and dk.shape == dv.shape == (B, S, KV, Hd)
    for got, w in zip((dq, dk, dv), want):
        assert _rel(got.numpy(), w) <= TOL
    # and through the autograd Function's dispatch (the plain versions on
    # the CPU: no kernel is launched)
    n = (fa.launches, fa.dq_launches, fa.dkv_launches)
    leaves = [_t(x).clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, return_lse=True, **pkw)
    cots = (_t(go), _t(glse)) if with_lse else (_t(go), None)
    got = torch.autograd.grad([x for x, c in zip(out, cots) if c is not None], leaves,
                              [c for c in cots if c is not None])
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == n
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), w) <= TOL


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX side, so its dispatch takes the bare
    Pallas kernels (interpret mode) as on one chip. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    jdist.set_mesh(saved)


@pytest.fixture(scope="module")
def gptj(one_device_mesh):
    jcfg = JT.TransformerConfig(remat=False, **GPTJ)
    jparams = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(5)))
    jparams["lm_head_bias"] = np.random.default_rng(5).normal(
        size=GPTJ["vocab_size"]).astype(np.float32) * 0.1
    return jcfg, jparams


def test_gptj_shaped_loss_and_grads_match_jax(gptj):
    """lm_loss of a 2-layer GPT-J of 2 heads x 256 and every leaf's
    gradient, with a key mask, against the JAX model's."""
    jcfg, jparams = gptj
    r = np.random.default_rng(6)
    batch = {"input_ids": r.integers(0, GPTJ["vocab_size"], size=(2, 48)).astype(np.int32),
             "attention_mask": (r.random((2, 48)) > 0.2).astype(np.int32)}
    batch["attention_mask"][:, 0] = 1
    want_loss, want = jax.value_and_grad(
        lambda p: JT.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch)))(
            jax.tree.map(jnp.asarray, jparams))
    cfg = TransformerConfig(**{**GPTJ, "remat": False})
    assert cfg.head_dim == 256
    params = params_from_jax(cfg, jparams).map(lambda t: t, requires_grad=True)
    n = (fa.dq_launches, fa.dkv_launches)
    loss = PT.lm_loss(cfg, params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    assert (fa.dq_launches, fa.dkv_launches) == n
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    grad_tree = params.map(torch.zeros_like)
    for (_, p), (_, g) in zip(params.named_parameters(), grad_tree.named_parameters()):
        g.data.copy_(p.grad)
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()),
                        params_to_jax(cfg, grad_tree), jax.tree.map(np.asarray, want))
    assert max(jax.tree.leaves(errs)) <= LEAF_TOL, errs


def test_gptj_shaped_engine_steps_match_jax(gptj):
    """Three train_batch steps (FusedAdam, WarmupLR from a non-zero first
    lr, clipping 1.0, remat) of the tiny GPT-J on the port's engine and on
    the JAX engine: losses within LOSS_TOL, relative, the last two after a
    real update each; then every leaf after the three updates, its
    difference from the JAX engine's within STEP_TOL of the JAX engine's
    change of that leaf."""
    jcfg, jparams = gptj
    config = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-4, "weight_decay": 0.1}},
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 3e-4,
                                       "warmup_num_steps": 2}},
              "gradient_clipping": 1.0, "fused_cross_entropy": "off"}
    jeng = deepspeed_tpu.initialize(model=JaxCausalLM(JT.TransformerConfig(**GPTJ)),
                                    model_parameters=jax.tree.map(jnp.asarray, jparams),
                                    config=config)[0]
    pmodel = CausalLM(TransformerConfig(**GPTJ))
    peng = deepspeed_tpu_torch.initialize(
        model=pmodel, model_parameters=params_from_jax(pmodel.config, jparams), config=config,
        device="cpu")[0]
    r = np.random.default_rng(7)
    for _ in range(3):
        batch = {"input_ids": r.integers(0, GPTJ["vocab_size"], size=(2, 32)).astype(np.int32)}
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert np.isfinite(got) and abs(got - want) <= LOSS_TOL * abs(want)
    moved = params_to_jax(pmodel.config, peng.state.params)
    errs = jax.tree.map(lambda a, b, c: float(np.abs(a - b).max() / np.abs(b - c).max()),
                        moved, jax.tree.map(np.asarray, jeng.state.params), jparams)
    assert max(jax.tree.leaves(errs)) <= STEP_TOL, errs
