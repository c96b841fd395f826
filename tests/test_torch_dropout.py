"""Dropout in ``deepspeed_tpu_torch``'s training paths, on the CPU at a tiny
Llama (2 layers, d_model 64). torch's generator cannot draw ``jax.random``'s
bits, so these tests check behaviour, not the JAX package's masks: rate 0 is
the identity, the kept share and the 1/keep scaling, full remat recomputing
the same masks, a deterministic ``eval_batch``, and ``DS_SEED`` seeding the
engine's dropout stream as it seeds the JAX engine's key."""

import math

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = dict(vocab_size=128, max_seq=32, n_layer=2, n_head=4, n_kv_head=2, d_model=64, d_ff=128,
            pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
            attention_backend="flash")
RATE = 0.1


def _params(cfg, seed=0):
    return PT.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _batch(seed=1, rows=2, S=32):
    r = np.random.default_rng(seed)
    return {"input_ids": torch.from_numpy(r.integers(0, TINY["vocab_size"], size=(rows, S)))}


def _config():
    return {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "fused_cross_entropy": "off"}


def test_rate_zero_is_the_identity():
    cfg = TransformerConfig(**{**TINY, "dropout": 0.0})
    x = torch.randn(4, 8, 64)
    assert PT._dropout(cfg, x, torch.Generator().manual_seed(3)) is x
    params, batch = _params(cfg), _batch()
    with torch.no_grad():
        with_rng = PT.lm_loss(cfg, params, batch, rng=torch.Generator().manual_seed(3))
        without = PT.lm_loss(cfg, params, batch)
    assert torch.equal(with_rng, without)


def test_kept_share_and_scaling():
    """Each element is kept with probability 1 - rate (the share within 4
    sigma of a binomial's) and a kept element is scaled by 1 / keep."""
    cfg = TransformerConfig(**{**TINY, "dropout": RATE})
    n = 1 << 18
    out = PT._dropout(cfg, torch.ones(n), torch.Generator().manual_seed(5))
    keep = 1.0 - RATE
    kept = out != 0
    share = float(kept.float().mean())
    assert abs(share - keep) <= 4 * math.sqrt(keep * RATE / n)
    assert torch.equal(out[kept], torch.full_like(out[kept], 1.0 / keep))
    other = PT._dropout(cfg, torch.ones(n), torch.Generator().manual_seed(6))
    assert not torch.equal(kept, other != 0)


@pytest.mark.parametrize("policy", [True, "selective", "dots", "offload_dots"])
def test_full_remat_recomputes_the_same_masks(policy):
    """With dropout on, full remat and the other remat policies give the
    gradients of no remat from the same dropout stream: each block's
    recompute draws the masks again from its own seed."""
    grads = []
    for remat in (policy, False):
        cfg = TransformerConfig(**{**TINY, "dropout": RATE, "remat": remat})
        params = _params(cfg).map(lambda t: t, requires_grad=True)
        PT.lm_loss(cfg, params, _batch(), rng=torch.Generator().manual_seed(9)).backward()
        grads.append([p.grad for p in params.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
    cfg = TransformerConfig(**{**TINY, "dropout": RATE, "remat": policy})
    params = _params(cfg).map(lambda t: t, requires_grad=True)
    PT.lm_loss(cfg, params, _batch(), rng=torch.Generator().manual_seed(10)).backward()
    other = [p.grad for p in params.parameters()]
    assert not all(torch.allclose(a, b) for a, b in zip(grads[1], other))


def _engine(monkeypatch, seed):
    if seed is None:
        monkeypatch.delenv("DS_SEED", raising=False)
    else:
        monkeypatch.setenv("DS_SEED", str(seed))
    cfg = TransformerConfig(**{**TINY, "dropout": RATE})
    return deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=_params(cfg),
                                          config=_config(), device="cpu")[0]


def test_eval_batch_is_deterministic(monkeypatch):
    """eval_batch draws no mask: it repeats, also after a train step has
    advanced the dropout stream, and equals the loss without dropout."""
    batch = _batch()
    engine = _engine(monkeypatch, 7)
    cfg = TransformerConfig(**{**TINY, "dropout": 0.0})
    with torch.no_grad():
        plain = PT.lm_loss(cfg, _params(cfg), batch)
    assert torch.equal(engine.eval_batch(batch), plain)
    assert torch.equal(engine.eval_batch(batch), plain)
    engine.train_batch(batch)
    after = engine.eval_batch(batch)
    assert torch.isfinite(after) and torch.equal(engine.eval_batch(batch), after)


def test_ds_seed_seeds_the_dropout_stream(monkeypatch):
    """Two engines with one DS_SEED give the same first loss; another seed
    draws other masks and another loss; no DS_SEED is seed 42."""
    batch = _batch()
    loss = lambda seed: float(_engine(monkeypatch, seed).train_batch(batch))
    assert loss(11) == loss(11)
    assert loss(11) != loss(12)
    assert loss(None) == loss(42)
