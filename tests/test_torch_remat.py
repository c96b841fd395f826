"""The port's remat policies (``runtime/activation_checkpointing``, used by
``models/transformer.run_layers``) against the JAX model's
``_remat_policy`` on the CPU, at a tiny Llama (2 layers, d_model 128, GQA)
and a tiny GPT-2 (biases, gelu, tied head), the same weights and tokens:
the loss and every leaf's gradient within ``1e-6 * max|g|`` of the JAX
model's under the same policy (the JAX flash path in interpret mode on a
one-device mesh). Within the port, every policy's loss and gradients are
bit-equal to full remat's (the same ops, with saved outputs in place of
recomputed ones); ``"selective"`` and no remat run no attention forward in
the backward, the others one a layer; the saved bytes order full <
selective < dots, with ``"offload_dots"`` saving what ``"dots"`` saves; and
the three policies train through ``initialize`` -> ``train_batch`` with the
losses and weights of full remat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

GRAD_TOL = 1e-6     # max |port - jax| over a leaf / max |jax| of the leaf (test_torch_training)
LOSS_TOL = 1e-6     # relative
LLAMA = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4, n_kv_head=2, d_model=128, d_ff=256,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             norm_eps=1e-6, attention_backend="flash")
GPT2 = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=2, d_model=128, pos_embedding="learned",
            norm="layernorm", activation="gelu", tie_embeddings=True, attn_bias=True,
            attention_backend="flash")
POLICIES = (True, "selective", "dots", "offload_dots", False)


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh, so the JAX model takes the bare Pallas kernels
    (interpret mode). Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def _tokens(seed=0, rows=2, S=64):
    return np.random.default_rng(seed).integers(0, 256, size=(rows, S))


def _jax_tree(kw, seed=3):
    tree = JT.init_params(JT.TransformerConfig(**kw), jax.random.key(seed))
    return jax.tree.map(np.asarray, tree)


def _port_grads(kw, remat, tree, toks, counted=None):
    """Loss and grads of the port's ``lm_loss`` under ``remat``; with
    ``counted`` a list, the attention wrappers' calls are appended to it
    (name, and whether the call is inside the backward)."""
    cfg = TransformerConfig(**{**kw, "remat": remat})
    params = params_from_jax(cfg, tree).map(lambda t: t, requires_grad=True)
    phase = ["forward"]
    if counted is not None:
        dispatch = fa._dispatch

        def spy(cuda_fn, plain_fn, name, q, *args):
            counted.append((name, phase[0]))
            return dispatch(cuda_fn, plain_fn, name, q, *args)
        fa._dispatch = spy
    try:
        ck.reset_stats()
        loss = PT.lm_loss(cfg, params, {"input_ids": torch.from_numpy(toks)})
        saved = dict(ck.stats)
        phase[0] = "backward"
        loss.backward()
    finally:
        if counted is not None:
            fa._dispatch = dispatch
    return cfg, loss.detach(), params, saved


@pytest.mark.parametrize("shape,remat", [("llama", r) for r in POLICIES]
                         + [("gpt2", "selective"), ("gpt2", "dots")])
def test_policy_matches_jax(one_device_mesh, shape, remat):
    kw = {"llama": LLAMA, "gpt2": GPT2}[shape]
    tree, toks = _jax_tree(kw), _tokens()
    jm = JaxCausalLM(JT.TransformerConfig(**{**kw, "remat": remat}))
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss(p, {"input_ids": jnp.asarray(toks)}))(jax.tree.map(jnp.asarray, tree))
    cfg, loss, params, _ = _port_grads(kw, remat, tree, toks)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    grads = params.map(torch.zeros_like)
    for (_, p), (_, g) in zip(params.named_parameters(), grads.named_parameters()):
        g.data.copy_(p.grad)
    got, want = params_to_jax(cfg, grads), jax.tree.map(np.asarray, want)
    if "bk" in want["layers"]["attn"]:
        # the key bias's exact gradient is zero (softmax ignores a shift of a
        # whole row of logits): both sides hold rounding residue there, held
        # to the scale of the key projection's gradient
        attn = want["layers"]["attn"]
        gap = np.abs(got["layers"]["attn"].pop("bk") - attn.pop("bk")).max()
        assert gap <= GRAD_TOL * np.abs(attn["wk"]).max()
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()), got, want)
    assert max(jax.tree.leaves(errs)) <= GRAD_TOL, errs


@pytest.mark.parametrize("remat", POLICIES[1:])
def test_policy_is_bit_equal_to_full_remat(remat):
    tree, toks = _jax_tree(LLAMA), _tokens(1)
    _, want_loss, want, _ = _port_grads(LLAMA, True, tree, toks)
    _, loss, got, _ = _port_grads(LLAMA, remat, tree, toks)
    assert torch.equal(loss, want_loss)
    for (n, p), (_, q) in zip(got.named_parameters(), want.named_parameters()):
        assert torch.equal(p.grad, q.grad), n


@pytest.mark.parametrize("remat,reruns", [(True, 1), ("selective", 0), ("dots", 1),
                                          ("offload_dots", 1), (False, 0)])
def test_attention_forwards_rerun_in_the_backward(remat, reruns):
    """Kernel A's wrapper in the backward: once a layer where the policy
    does not keep its (o, lse); C and D once a layer under every policy."""
    calls = []
    _port_grads(LLAMA, remat, _jax_tree(LLAMA), _tokens(), counted=calls)
    L = LLAMA["n_layer"]
    assert calls.count(("flash_attention", "forward")) == L
    assert calls.count(("flash_attention", "backward")) == reruns * L
    assert calls.count(("flash_attention_dq", "backward")) == L
    assert calls.count(("flash_attention_dkv", "backward")) == L


def test_saved_bytes_order():
    """What each policy keeps beyond the blocks' inputs, against the
    shapes: "selective" 6 widths of d_model a token and the lse (H floats a
    token) a layer, "dots" every product (4 projections, 2 d_ff-wide and
    the down product); "offload_dots" the same bytes as "dots", in host
    memory (this tensor is already there on the CPU)."""
    tree, toks = _jax_tree(LLAMA), _tokens()
    saved = {r: _port_grads(LLAMA, r, tree, toks)[3]["saved_bytes"] for r in POLICIES}
    L, tokens, D, KVD = LLAMA["n_layer"], toks.size, LLAMA["d_model"], 2 * 32
    Fd, H = LLAMA["d_ff"], LLAMA["n_head"]
    assert saved[True] == saved[False] == 0
    assert saved["selective"] == 4 * L * tokens * (4 * D + 2 * KVD + H)
    assert saved["dots"] == saved["offload_dots"] == 4 * L * tokens * (2 * D + 2 * KVD + 2 * Fd + D)
    assert saved[True] < saved["selective"] < saved["dots"]


def _config():
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "fused_cross_entropy": "off"}


def test_policies_train_through_the_engine():
    """Three train_batch steps under each policy: the losses and the
    trained weights of full remat, bit for bit."""
    tree = _jax_tree(LLAMA)
    batches = [{"input_ids": _tokens(s, rows=4)} for s in range(3)]
    runs = {}
    for remat in (True, "selective", "dots", "offload_dots"):
        model = CausalLM(TransformerConfig(**{**LLAMA, "remat": remat}))
        engine = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=params_from_jax(model.config, tree), config=_config(),
            device="cpu")[0]
        runs[remat] = ([float(engine.train_batch(b)) for b in batches], engine.state.params)
    for remat, (losses, params) in runs.items():
        assert losses == runs[True][0], remat
        for (n, p), (_, q) in zip(params.named_parameters(), runs[True][1].named_parameters()):
            assert torch.equal(p, q), (remat, n)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        PT._remat("some")
    with pytest.raises(ValueError, match="unknown remat policy"):
        ck.remat("some", lambda x: x, torch.zeros(1))
