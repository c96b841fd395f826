"""The same request traces through both packages' continuous-batching
schedulers, with a fake (deterministic) sampler standing in for the model:
the sequence of actions (kind, rids, chunk geometry, copy-on-write splits),
every block table, the outputs and the ``stats`` dicts are identical. The
traces cover pool pressure that forces preemption, shared prefixes that hit
the prefix cache across calls with a copy-on-write split, and chunked
prefill."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import block_allocator as jax_alloc
from deepspeed_tpu.inference import scheduler as jax_sched
import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import block_allocator as port_alloc
from deepspeed_tpu_torch.inference import scheduler as port_sched
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

VOCAB = 11


def _fake_token(req):
    """A sampler stand-in that depends on the request's content."""
    seq = req.prefix()
    return int((seq[-3:].sum() * 7 + len(req.generated) * 3 + req.rid) % VOCAB)


def _drive(sched, prompts, max_new, eos=None):
    """Run one serve to completion the way the engine does; returns the
    action trace."""
    for p in prompts:
        sched.add_request(p, max_new, eos)
    trace = []
    while True:
        action = sched.next_action()
        if action is None:
            return trace
        kind, payload = action
        if kind == "prefill":
            r = payload
            trace.append((kind, r.rid, tuple(r.blocks), r.pos))
            sched.record_prefill(r, _fake_token(r))
        elif kind == "prefill_chunk":
            r = payload
            cow, r.cow_pending = r.cow_pending, None
            start = r.pos
            remaining = r.prefill_target - start
            step = min(sched.chunk_tokens, remaining) if sched.chunk_tokens else remaining
            trace.append((kind, r.rid, start, step, cow, tuple(r.blocks)))
            if start + step == r.prefill_target:
                sched.record_prefill_chunk(r, step, _fake_token(r))
            else:
                sched.record_prefill_chunk(r, step)
        elif kind == "decode":
            trace.append((kind, tuple(r.rid for r in payload),
                          tuple(tuple(r.blocks) for r in payload),
                          tuple(r.pos for r in payload)))
            for r in payload:
                sched.record_decode(r, _fake_token(r))
        else:
            raise AssertionError(f"unexpected action {kind}")


def _serve_rounds(mod_sched, mod_alloc, rounds, num_blocks, bs, W, n_max, caching,
                  chunk, max_new, eos=None):
    """Several serve calls over one persistent allocator (as the engine
    keeps it across generate_batch calls with prefix caching)."""
    alloc = mod_alloc.BlockAllocator(num_blocks, bs, prefix_cache=caching)
    rid_base = 0
    out = []
    for prompts in rounds:
        s = mod_sched.ContinuousBatchingScheduler(alloc, W, n_max, prefix_caching=caching,
                                                  chunk_tokens=chunk, rid_base=rid_base)
        trace = _drive(s, prompts, max_new, eos)
        rid_base = s._next_rid
        outputs = {r.rid: (r.output.tolist(), r.error, r.preemptions) for r in s.finished}
        out.append((trace, dict(s.stats), outputs, alloc.leak_report(), alloc.num_cold))
    return out


def _prompts(seed, lengths, shared=None):
    r = np.random.default_rng(seed)
    ps = [r.integers(0, VOCAB, size=n).astype(np.int32) for n in lengths]
    if shared is not None:
        ps = [np.concatenate([shared, p]) for p in ps]
    return ps


SCENARIOS = {
    # small pool: decode growth evicts the latest-admitted request
    "preemption": dict(rounds=[_prompts(0, (5, 9, 7, 6))], num_blocks=7, bs=4, W=3,
                       n_max=8, caching=False, chunk=0, max_new=9),
    "preemption_cached": dict(rounds=[_prompts(1, (5, 9, 7, 6))], num_blocks=7, bs=4, W=3,
                              n_max=8, caching=True, chunk=0, max_new=9),
    # shared system prompt + a second call repeating a whole prompt: cache
    # hits, a full-prefix hit with its copy-on-write split
    "prefix_cache_cow": dict(
        rounds=[_prompts(2, (3, 6, 0), shared=np.arange(8, dtype=np.int32) % VOCAB),
                _prompts(2, (3, 6, 0), shared=np.arange(8, dtype=np.int32) % VOCAB)
                + _prompts(3, (5,))],
        num_blocks=24, bs=4, W=2, n_max=8, caching=True, chunk=0, max_new=5),
    "chunked_prefill": dict(rounds=[_prompts(4, (13, 3, 10)), _prompts(4, (13,))],
                            num_blocks=20, bs=4, W=2, n_max=8, caching=True, chunk=4,
                            max_new=6),
    "eos": dict(rounds=[_prompts(5, (4, 7, 5))], num_blocks=12, bs=4, W=3, n_max=6,
                caching=True, chunk=0, max_new=12, eos=3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_action_traces_match(name):
    sc = dict(SCENARIOS[name])
    rounds = sc.pop("rounds")
    want = _serve_rounds(jax_sched, jax_alloc, rounds, **sc)
    got = _serve_rounds(port_sched, port_alloc, rounds, **sc)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"round {i}: action trace differs"
        assert g[1] == w[1], f"round {i}: stats differ"
        assert g[2] == w[2], f"round {i}: outputs differ"
        assert g[3] == w[3] == {}, f"round {i}: leaked blocks"
        assert g[4] == w[4], f"round {i}: cold blocks differ"
    kinds = {a[0] for g in got for a in g[0]}
    if name.startswith("preemption"):
        assert got[0][1]["preemptions"] > 0
    if name == "prefix_cache_cow":
        cows = [a for a in got[1][0] if a[0] == "prefill_chunk" and a[4] is not None]
        assert cows, "the repeated prompt should split a shared block"
    if name == "chunked_prefill":
        assert "prefill_chunk" in kinds and "decode" in kinds


def test_scheduler_refuses_telemetry_hooks():
    """The scheduler takes the serving telemetry and the flight recorder
    (every series pre-created at zero). Nothing of the control plane is
    refused any more: the serving engine, as the JAX one, acts on none of
    the sampler, SLOs, controller or /metrics settings (the async serving
    front-end takes them from ``serve``'s flags), so it builds with each."""
    from deepspeed_tpu_torch.monitor.events import FlightRecorder
    from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry
    reg = MetricsRegistry()
    port_sched.ContinuousBatchingScheduler(
        port_alloc.BlockAllocator(4, 4), 1, 2,
        telemetry=port_sched.ServingTelemetry(reg), events=FlightRecorder(enabled=True))
    snap = reg.snapshot()
    assert snap["counters"]["serving/preemptions"] == 0
    assert snap["histograms"]["serving/ttft_ms"]["count"] == 0
    model = CausalLM(TransformerConfig(vocab_size=64, n_layer=1, n_head=2, d_model=32,
                                       d_ff=64, max_seq=64))
    for sub in ("sampler", "slo", "ctl", "metrics_port"):
        eng = deepspeed_tpu_torch.init_inference(
            model, dtype="fp32", device="cpu",
            telemetry={sub: 0 if sub == "metrics_port" else True})
        assert eng._telemetry is not None
    # telemetry.health: the JAX serving engine acts on none of it, nor does the port's
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                             telemetry={"health": True})
    assert eng._telemetry is not None
