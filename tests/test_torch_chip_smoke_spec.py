"""Phase ``spec_parity``'s verify logits and phase ``spec_serve``'s near-tie
rule, launch formula and oracle serve of ``chip_smoke.py`` on the CPU.
Apart from ``test_torch_chip_smoke.py`` so the test runner can place them
on another worker."""

import numpy as np
import pytest
import torch

import chip_smoke
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from tests.test_torch_chip_smoke import LLAMA, engine  # noqa: F401 (fixture)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


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
