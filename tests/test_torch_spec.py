"""Speculative decoding in the port against the JAX package, on the CPU.

- The n-gram proposer: the JAX package's proposer cases, and equal
  proposals from both packages on 400 seeded sequences over narrow
  vocabularies.
- The allocator's rollback (``unregister_if_owner``) and the scheduler's
  verify bookkeeping: every scenario of the JAX package's spec tests run
  through both packages, whose observations must be equal; then whole
  serves with each package's own proposer and a deterministic stand-in for
  the model, whose action traces, outputs and ``stats`` must be equal.
- The fused verify step: ``forward_paged_verify`` against the JAX one on the
  einsum path and on the kernel path (the JAX engine's Pallas kernel in
  interpret mode on a one-device mesh; the port's paged kernel wrapper,
  which takes its plain version for CPU tensors, once per window position
  and layer), fp32 logits and pools within 1e-4.
- Whole serves: ``generate_batch`` with ``serving.speculative.mode="ngram"``
  against the JAX engine's on the scenarios of its spec tests (tokens and
  scheduler stats equal), and against the port with speculation off
  (tokens equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import block_allocator as jax_alloc
from deepspeed_tpu.inference import scheduler as jax_sched
from deepspeed_tpu.inference.spec import NgramProposer as JaxNgramProposer
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference import block_allocator as port_alloc
from deepspeed_tpu_torch.inference import scheduler as port_sched
from deepspeed_tpu_torch.inference.spec import NgramProposer
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.models import transformer as PT

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

PACKAGES = {"jax": (jax_sched, jax_alloc), "port": (port_sched, port_alloc)}
LOGIT_TOL = 1e-4     # fp32 logits and pools, absolute (the sums run in other orders)


# --------------------------------------------------------------------- #
# the n-gram proposer


def test_basic_tail_match():
    assert list(NgramProposer(2, 2).propose([1, 2, 3, 4, 5, 6, 7, 3, 4], k=3)) == [5, 6, 7]


def test_longest_match_wins():
    # the 3-gram [2, 3, 4] (-> 9) beats the later 2-gram [3, 4] (-> 8)
    assert list(NgramProposer(2, 4).propose([1, 2, 3, 4, 9, 3, 4, 8, 2, 3, 4], k=1)) == [9]


def test_most_recent_occurrence_on_ties():
    assert list(NgramProposer(2, 2).propose([1, 2, 7, 1, 2, 8, 9, 1, 2], k=1)) == [8]


def test_no_match_and_short_sequences():
    p = NgramProposer(2, 4)
    assert p.propose([1, 2, 3, 4, 5], k=4).size == 0
    assert p.propose([1], k=4).size == 0
    assert p.propose([], k=4).size == 0
    assert p.propose([1, 2, 1, 2], k=0).size == 0


def test_min_match_respected():
    assert NgramProposer(2, 4).propose([5, 1, 2, 3, 5], k=2).size == 0
    assert list(NgramProposer(1, 4).propose([5, 1, 2, 3, 5], k=1)) == [1]


def test_periodic_extension_and_k_clamp():
    p = NgramProposer(2, 4)
    got = p.propose([7, 8, 9, 7, 8, 9, 7, 8, 9], k=8)
    assert list(got)[:3] == [7, 8, 9] and got.size <= 8
    assert list(p.propose([1, 2, 3, 9, 1, 2, 3], k=2)) == [9, 1]


def test_proposer_validation_matches_jax():
    for mn, mx, match in ((0, 4, "min_match"), (3, 2, "max_match")):
        msgs = []
        for cls in (NgramProposer, JaxNgramProposer):
            with pytest.raises(ValueError, match=match) as err:
                cls(min_match=mn, max_match=mx)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_proposals_equal_jax_on_seeded_sequences():
    r = np.random.default_rng(0)
    found = 0
    for _ in range(400):
        vocab = int(r.integers(2, 6))
        seq = r.integers(0, vocab, size=int(r.integers(0, 48))).astype(np.int32)
        mn = int(r.integers(1, 4))
        mx = mn + int(r.integers(0, 4))
        k = int(r.integers(0, 8))
        got = NgramProposer(mn, mx).propose(seq, k)
        want = JaxNgramProposer(mn, mx).propose(seq, k)
        assert got.dtype == np.int32 and np.array_equal(got, want), (seq, mn, mx, k)
        found += int(got.size > 0)
    assert found > 200           # most draws over a narrow vocabulary do match


# --------------------------------------------------------------------- #
# allocator rollback: the JAX package's unregister_if_owner scenarios


def _unreg_owner(A):
    a = A.BlockAllocator(6, 4, prefix_cache=True)
    (b,) = a.allocate(1)
    key = a.chain_key(A.ROOT_KEY, [1, 2, 3, 4])
    out = [a.register(b, key), a.unregister_if_owner(b, key), a.match_prefix([1, 2, 3, 4]),
           a.ref_count(b)]
    (b2,) = a.allocate(1)
    return out + [a.register(b2, key), a.match_prefix([1, 2, 3, 4])[0] == [b2]]


def _unreg_non_owner(A):
    a = A.BlockAllocator(6, 4, prefix_cache=True)
    first, second = a.allocate(2)
    key = a.chain_key(A.ROOT_KEY, [1, 2, 3, 4])
    return [a.register(first, key), a.register(second, key),
            a.unregister_if_owner(second, key), a.match_prefix([1, 2, 3, 4])[0] == [first]]


def _unreg_wrong_key(A):
    a = A.BlockAllocator(6, 4, prefix_cache=True)
    (b,) = a.allocate(1)
    key = a.chain_key(A.ROOT_KEY, [1, 2, 3, 4])
    a.register(b, key)
    return [a.unregister_if_owner(b, a.chain_key(A.ROOT_KEY, [9])),
            a.match_prefix([1, 2, 3, 4])[0] == [b]]


def _unreg_cold_block(A):
    a = A.BlockAllocator(3, 4, prefix_cache=True)
    got = a.allocate(2)
    key = a.chain_key(A.ROOT_KEY, [1, 2, 3, 4])
    a.register(got[0], key)
    a.free(list(reversed(got)))
    out = [a.num_cold, a.unregister_if_owner(got[0], key), a.num_cold, a.num_free]
    return out + [sorted(a.allocate(2)) == sorted(got)]


def _unreg_cache_off(A):
    a = A.BlockAllocator(4, 4)
    (b,) = a.allocate(1)
    return [a.unregister_if_owner(b, b"anything")]


UNREGISTER = {
    "owner_unregisters_and_key_is_reusable": (_unreg_owner, [True, True, ([], []), 1, True, True]),
    "non_owner_is_a_noop": (_unreg_non_owner, [True, False, False, True]),
    "wrong_key_is_a_noop": (_unreg_wrong_key, [False, True]),
    "cold_block_moves_to_free_list": (_unreg_cold_block, [1, True, 0, 2, True]),
    "prefix_cache_off_is_a_noop": (_unreg_cache_off, [False]),
}


@pytest.mark.parametrize("name", sorted(UNREGISTER))
def test_unregister_if_owner_matches_jax(name):
    fn, expected = UNREGISTER[name]
    got, want = fn(port_alloc), fn(jax_alloc)
    assert got == want == expected


# --------------------------------------------------------------------- #
# scheduler: the JAX package's verify scenarios through both schedulers


class FakeProposer:
    """Scripted proposer: the next canned candidate list a call (empty once
    the script is used up), recording every (sequence, k) it saw."""

    def __init__(self, script=()):
        self.script = [np.asarray(s, np.int32) for s in script]
        self.calls = []

    def propose(self, seq, k):
        self.calls.append((np.asarray(seq, np.int32).tolist(), k))
        if not self.script:
            return np.zeros((0,), np.int32)
        return self.script.pop(0)[:k]


def _spec_sched(pkg, script, num_blocks=9, block_size=4, max_running=2, n_max=8, k=4):
    S, A = PACKAGES[pkg]
    alloc = A.BlockAllocator(num_blocks, block_size, prefix_cache=True)
    prop = FakeProposer(script)
    return S.ContinuousBatchingScheduler(alloc, max_running, n_max, prefix_caching=True,
                                         spec_k=k, spec_proposer=prop), prop


def _admit_one(s, prompt=(1, 2, 3, 4), max_new=8, first_tok=5, eos=None):
    r = s.add_request(list(prompt), max_new=max_new, eos=eos)
    kind, req = s.next_action()
    assert kind == "prefill" and req is r
    s.record_prefill(r, first_tok)
    return r


def _state(s, r):
    """What a scenario observes of one request and its scheduler."""
    return {"generated": list(r.generated), "pos": r.pos, "blocks": list(r.blocks),
            "keys": list(r.keys), "state": r.state, "spec_tokens": tuple(r.spec_tokens),
            "preemptions": r.preemptions, "stats": dict(s.stats),
            "output": np.asarray(r.output).tolist(), "free": s.allocator.num_free}


def _sc_full_acceptance(pkg):
    s, _ = _spec_sched(pkg, [[9, 8, 7]])
    r = _admit_one(s)
    kind, reqs = s.next_action()
    out = [kind, [q.rid for q in reqs], tuple(r.spec_tokens)]
    s.record_verify(r, [9, 8, 7, 6])
    return out + [_state(s, r)]


def _sc_no_match(pkg):
    s, prop = _spec_sched(pkg, [])
    r = _admit_one(s)
    kind, reqs = s.next_action()
    return [kind, [q.rid for q in reqs], prop.calls, _state(s, r)]


def _sc_rollback_boundary(pkg):
    s, _ = _spec_sched(pkg, [[9, 9, 9, 9]])
    a = s.allocator
    r = _admit_one(s)
    kind, _ = s.next_action()
    s.record_verify(r, [7])
    return [kind, _state(s, r), a.match_prefix([1, 2, 3, 4])[0],
            a.match_prefix([1, 2, 3, 4, 5, 9, 9, 9])[0]]


def _sc_rollback_first_writer(pkg):
    s, _ = _spec_sched(pkg, [[9, 9, 9, 9]])
    A = PACKAGES[pkg][1]
    a = s.allocator
    r = _admit_one(s)
    key0 = a.chain_key(A.ROOT_KEY, [1, 2, 3, 4])
    key1 = a.chain_key(key0, [5, 9, 9, 9])
    (other,) = a.allocate(1)
    registered = a.register(other, key1)
    kind, _ = s.next_action()
    s.record_verify(r, [7])
    out = [registered, kind, a.match_prefix([1, 2, 3, 4, 5, 9, 9, 9])[0], other, _state(s, r)]
    a.free([other])
    return out


def _sc_rollback_preempt_readmit(pkg):
    s, _ = _spec_sched(pkg, [[9, 9, 9, 9]])
    a = s.allocator
    r = _admit_one(s)
    s.next_action()
    s.record_verify(r, [7])
    b0 = r.blocks[0]
    s._preempt(r)
    out = [r.state, list(r.blocks), a.match_prefix(np.asarray(r.prefix()))[0], b0]
    kind, req = s.next_action()
    return out + [kind, req is r, _state(s, r)]


def _sc_window_truncates(pkg):
    s, _ = _spec_sched(pkg, [[9, 8, 7, 6]], num_blocks=3, max_running=1)
    r = _admit_one(s)
    kind, _ = s.next_action()
    out = [kind, tuple(r.spec_tokens), r.preemptions, r.state]
    s.record_verify(r, [9, 8, 7, 3])
    return out + [_state(s, r)]


def _sc_headroom(pkg):
    s, prop = _spec_sched(pkg, [[9, 8, 7, 6]])
    r = _admit_one(s, max_new=3)
    kind, _ = s.next_action()
    out = [kind, tuple(r.spec_tokens), prop.calls]
    s.record_verify(r, [9, 4])
    return out + [_state(s, r)]


def _sc_eos_in_window(pkg):
    s, _ = _spec_sched(pkg, [[9, 8, 7]])
    r = _admit_one(s, eos=9)
    s.next_action()
    s.record_verify(r, [9, 8, 7, 6])
    return [_state(s, r)]


def _sc_preempt_clears(pkg):
    s, _ = _spec_sched(pkg, [[9, 8, 7]])
    r = _admit_one(s)
    s.next_action()
    before = tuple(r.spec_tokens)
    s._preempt(r)
    return [before, _state(s, r)]


def _sc_emitted_validation(pkg):
    s, _ = _spec_sched(pkg, [[9, 8]])
    r = _admit_one(s)
    s.next_action()
    with pytest.raises(ValueError, match="emitted") as err:
        s.record_verify(r, [9, 8, 7, 6, 5])
    return [str(err.value)]


SCHEDULER = {
    "verify_action_and_full_acceptance": _sc_full_acceptance,
    "no_match_falls_back_to_plain_decode": _sc_no_match,
    "rollback_unregisters_boundary_crossing_block": _sc_rollback_boundary,
    "rollback_preserves_first_writer": _sc_rollback_first_writer,
    "rollback_then_preempt_and_readmit": _sc_rollback_preempt_readmit,
    "window_growth_truncates_instead_of_preempting": _sc_window_truncates,
    "headroom_clamps_proposal_length": _sc_headroom,
    "eos_inside_window_truncates_like_plain_decode": _sc_eos_in_window,
    "preempt_clears_pending_candidates": _sc_preempt_clears,
    "emitted_vs_window_validation": _sc_emitted_validation,
}


@pytest.mark.parametrize("name", sorted(SCHEDULER))
def test_scheduler_verify_scenario_matches_jax(name):
    got, want = SCHEDULER[name]("port"), SCHEDULER[name]("jax")
    assert got == want


def test_scheduler_verify_scenarios_hold_the_jax_expectations():
    """The JAX package's own assertions, on the port's observations."""
    kind, rids, cands, st = _sc_full_acceptance("port")
    assert kind == "verify" and cands == (9, 8, 7)
    assert st["generated"] == [5, 9, 8, 7, 6] and st["pos"] == 8
    assert (st["stats"]["verify_steps"], st["stats"]["spec_accepted"],
            st["stats"]["spec_rollbacks"]) == (1, 3, 0)
    kind, _, _, st = _sc_no_match("port")
    assert kind == "decode" and st["stats"]["decode_steps"] == 1
    kind, st, hit0, hit_bogus = _sc_rollback_boundary("port")
    assert st["generated"] == [5, 7] and st["pos"] == 5 and len(st["keys"]) == 1
    assert hit0 == hit_bogus == [st["blocks"][0]] and st["stats"]["spec_rollbacks"] == 1
    _, _, hit, other, st = _sc_rollback_first_writer("port")
    assert hit == [st["blocks"][0], other]
    out = _sc_rollback_preempt_readmit("port")
    assert out[0] == port_sched.QUEUED and out[1] == [] and out[2] == [out[3]]
    assert out[4] == "prefill_chunk" and out[5] and out[6]["pos"] == 4
    kind, cands, preempted, state, _ = _sc_window_truncates("port")
    assert cands == (9, 8, 7) and preempted == 0 and state == "running"
    _, cands, _, st = _sc_headroom("port")
    assert len(cands) == 1 and st["state"] == port_sched.FINISHED
    assert st["output"] == [1, 2, 3, 4, 5, 9, 4]
    (st,) = _sc_eos_in_window("port")
    assert st["output"] == [1, 2, 3, 4, 5, 9] and st["stats"]["spec_rollbacks"] == 1
    before, st = _sc_preempt_clears("port")
    assert before and st["spec_tokens"] == ()


VOCAB = 7


def _fake_model(seq):
    """A deterministic greedy stand-in for the model: mostly period 4, with
    a shifted token every 5th position so candidates get rejected."""
    seq = np.asarray(seq)
    return int((seq[-4] + (len(seq) % 5 == 0)) % VOCAB) if len(seq) >= 4 else int(seq.sum() % VOCAB)


def _drive(sched, prompts, max_new, eos=None):
    """One serve to completion as the engine runs it, the fake model
    standing in for the forwards; returns the action trace."""
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
            sched.record_prefill(r, _fake_model(r.prefix()))
        elif kind == "prefill_chunk":
            r = payload
            cow, r.cow_pending = r.cow_pending, None
            start = r.pos
            remaining = r.prefill_target - start
            step = min(sched.chunk_tokens, remaining) if sched.chunk_tokens else remaining
            trace.append((kind, r.rid, start, step, cow, tuple(r.blocks)))
            if start + step == r.prefill_target:
                sched.record_prefill_chunk(r, step, _fake_model(r.prefix()))
            else:
                sched.record_prefill_chunk(r, step)
        elif kind == "decode":
            trace.append((kind, tuple(r.rid for r in payload),
                          tuple(tuple(r.blocks) for r in payload), tuple(r.pos for r in payload)))
            for r in payload:
                sched.record_decode(r, _fake_model(r.prefix()))
        elif kind == "verify":
            trace.append((kind, tuple(r.rid for r in payload),
                          tuple(tuple(r.blocks) for r in payload),
                          tuple(r.pos for r in payload),
                          tuple(tuple(r.spec_tokens) for r in payload)))
            for r in payload:
                seq, emitted = list(r.prefix()), []
                for c in list(r.spec_tokens) + [None]:
                    tok = _fake_model(seq)
                    emitted.append(tok)
                    if tok != c:
                        break
                    seq.append(tok)
                if r.eos is not None and r.eos in emitted:
                    emitted = emitted[:emitted.index(r.eos) + 1]
                sched.record_verify(r, emitted)
        else:
            raise AssertionError(f"unexpected action {kind}")


def _serve_rounds(pkg, rounds, num_blocks, bs, W, n_max, caching, chunk, max_new, k, eos=None):
    S, A = PACKAGES[pkg]
    proposer = (JaxNgramProposer if pkg == "jax" else NgramProposer)(2, 4) if k else None
    alloc = A.BlockAllocator(num_blocks, bs, prefix_cache=caching)
    rid_base, out = 0, []
    for prompts in rounds:
        s = S.ContinuousBatchingScheduler(alloc, W, n_max, prefix_caching=caching,
                                          chunk_tokens=chunk, rid_base=rid_base,
                                          spec_k=k, spec_proposer=proposer)
        trace = _drive(s, prompts, max_new, eos)
        rid_base = s._next_rid
        outputs = {r.rid: (r.output.tolist(), r.error, r.preemptions) for r in s.finished}
        out.append((trace, dict(s.stats), outputs, alloc.leak_report(), alloc.num_cold))
    return out


def _rounds(seed, n_rounds, lengths, shared=0):
    r = np.random.default_rng(seed)
    base = r.integers(0, VOCAB, size=shared).astype(np.int32)
    return [[np.concatenate([base, r.integers(0, VOCAB, size=n).astype(np.int32)])
             for n in lengths] for _ in range(n_rounds)]


# (rounds, num_blocks, bs, W, n_max, caching, chunk, max_new, k, eos)
TRACES = {
    "pool_pressure_preempts": (_rounds(1, 1, (9, 13, 6)), 10, 4, 3, 12, False, 0, 14, 4, None),
    "prefix_cache_across_calls": (_rounds(2, 2, (5, 9), shared=8), 24, 4, 2, 10, True, 0, 12, 3,
                                  None),
    "chunked_prefill_interleave": (_rounds(3, 1, (4, 23, 11)), 40, 4, 3, 12, True, 4, 12, 4,
                                   None),
    "eos_and_window_bucket_k7": (_rounds(4, 1, (6, 10)), 30, 8, 2, 8, True, 0, 20, 7, 3),
    "pressure_with_prefix_cache": (_rounds(5, 2, (12, 10), shared=4), 9, 4, 2, 12, True, 0, 12,
                                   4, None),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_spec_serve_traces_match_jax(name):
    """Both schedulers with their own n-gram proposer: equal action traces,
    outputs and stats; the outputs equal those of the same serve with
    speculation off (the fake model is greedy, so speculation changes only
    the step count)."""
    args = TRACES[name]
    got, want = _serve_rounds("port", *args), _serve_rounds("jax", *args)
    assert got == want
    off = _serve_rounds("port", *args[:-2], 0, args[-1])
    tokens = lambda rounds: [{rid: o[0] for rid, o in r[2].items()} for r in rounds]
    assert tokens(got) == tokens(off)
    stats = [o[1] for o in got]
    assert sum(s["verify_steps"] for s in stats) > 0
    assert sum(s["spec_accepted"] for s in stats) > 0
    if name.startswith("pool_pressure") or name.startswith("pressure"):
        assert sum(s["preemptions"] for s in stats) > 0


# --------------------------------------------------------------------- #
# the fused verify step


@pytest.fixture(scope="module")
def one_device_mesh():
    """A one-device mesh for the JAX package, so that its dispatch takes the
    bare Pallas kernels (interpret mode) as on one chip, instead of the
    einsum the 8-device CPU test mesh would give it. Restored after."""
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    jdist.set_mesh(build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    jdist.set_mesh(saved)


# Llama-shaped: rope, rmsnorm, swiglu, GQA 2, Hd 64 (inside the paged
# kernel's envelope at block 128)
VERIFY_SHAPE = dict(vocab_size=96, max_seq=512, n_layer=2, n_head=4, n_kv_head=2,
                    d_model=256, d_ff=384, pos_embedding="rope", norm="rmsnorm",
                    activation="swiglu", tie_embeddings=False, norm_eps=1e-6, remat=False)


def _window(pos, nv, table, W, bs):
    """One row's flat slots of a verify window (the engine's _flat_slots)."""
    t = np.arange(W)
    p_t = pos + t
    slot = table[np.minimum(p_t // bs, table.size - 1)] * bs + p_t % bs
    return np.where(t < nv, slot, p_t % bs)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_verify_step_matches_jax(backend, one_device_mesh, monkeypatch):
    """Two verify steps over three rows (a request deep in its second
    block, one whose window crosses a block boundary, an idle row) after
    filling the pools with the same random k/v: logits at every live
    window position and the pools (but the dummy block, where pads of
    several rows collide) within 1e-4. On the kernel path the port calls
    the paged kernel's wrapper once per window position and layer."""
    jcfg = JT.TransformerConfig(attention_backend=backend, **VERIFY_SHAPE)
    pcfg = PT.TransformerConfig(attention_backend="auto" if backend == "flash" else "xla",
                                **VERIFY_SHAPE)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(5)))
    params = params_from_jax(pcfg, tree)
    r = np.random.default_rng(7)
    L, nb, bs, KV, Hd = VERIFY_SHAPE["n_layer"], 7, 128, 2, 64
    kv = [r.normal(size=(L, nb, bs, KV, Hd)).astype(np.float32) for _ in range(2)]
    jpools = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
    pools = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy())}
    calls = []
    real = PT.paged_decode_attention
    aligned = []        # kernel B's wrapper wants pos 16-byte aligned on the card
    monkeypatch.setattr(PT, "paged_decode_attention",
                        lambda *a, **kw: aligned.append(a[4].data_ptr() % 16 == 0)
                        or calls.append(a[4].clone()) or real(*a, **kw))

    W, n_max = 8, 4
    tables = [np.asarray([2, 5], np.int32), np.asarray([3, 1], np.int32), None]
    for step, (pos, nvs) in enumerate((([200, 125, 0], [5, 4, 0]), ([203, 127, 0], [3, 8, 0]))):
        bt = np.zeros((3, n_max), np.int32)
        toks = r.integers(0, VERIFY_SHAPE["vocab_size"], size=(3, W)).astype(np.int32)
        slots = np.zeros((3, W), np.int64)
        for i, table in enumerate(tables):
            if table is None:
                slots[i] = _window(0, 0, np.zeros(1, np.int32), W, bs)
                continue
            bt[i, :table.size] = table
            slots[i] = _window(pos[i], nvs[i], table, W, bs)
        pos = np.asarray(pos, np.int32)
        jl, jpools = JT.forward_paged_verify(jcfg, tree, jnp.asarray(toks), jpools, jnp.asarray(bt),
                                             jnp.asarray(slots, jnp.int32), jnp.asarray(pos))
        n0 = len(calls)
        pl, pools = PT.forward_paged_verify(pcfg, params, torch.from_numpy(toks).long(), pools,
                                            torch.from_numpy(bt), torch.from_numpy(slots),
                                            torch.from_numpy(pos))
        assert pl.shape == (3, W, VERIFY_SHAPE["vocab_size"])
        if backend == "flash":
            assert len(calls) - n0 == L * W
            assert [c.dtype for c in calls[n0:]] == [torch.int32] * (L * W)
            assert all(c.is_contiguous() for c in calls[n0:])
            assert [c.tolist() for c in calls[n0:n0 + W]] == [list(pos + t) for t in range(W)]
            assert all(aligned[n0:])
        else:
            assert len(calls) == 0
        for i, nv in enumerate(nvs):
            np.testing.assert_allclose(pl[i, :nv].numpy(), np.asarray(jl)[i, :nv],
                                       atol=LOGIT_TOL, rtol=0, err_msg=f"step {step} row {i}")
        for key in ("k", "v"):
            np.testing.assert_allclose(pools[key][:, 1:].numpy(), np.asarray(jpools[key])[:, 1:],
                                       atol=LOGIT_TOL, rtol=0, err_msg=f"step {step} {key} pool")


# --------------------------------------------------------------------- #
# whole serves: generate_batch with speculation, port against the JAX engine


TINY = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, d_ff=64, max_seq=128)
KERNEL_TINY = dict(vocab_size=32, n_layer=1, n_head=1, d_model=64, d_ff=64, max_seq=256)
BASE = {"block_size": 8, "max_running": 2}


class _Trio:
    """The JAX engine and the port's with speculation on, and the port's with
    it off, over one set of weights. Each scenario re-points the serving
    knobs of all three (generate_batch re-reads them a call), so the JAX
    engine compiles its paged programs once."""

    def __init__(self, shape, k=4, **serving):
        jmodel = JaxCausalLM(JT.TransformerConfig(remat=False, **shape))
        tree = jax.tree.map(np.asarray, JT.init_params(jmodel.config, jax.random.key(0)))
        pmodel = CausalLM(TransformerConfig(**shape))
        params = params_from_jax(pmodel.config, tree)
        srv = {**BASE, **serving}
        spec = {**srv, "speculative": {"mode": "ngram", "k": k}}
        self.jax = deepspeed_tpu.init_inference(jmodel, params=tree, dtype="fp32", serving=spec)
        self.on = deepspeed_tpu_torch.init_inference(pmodel, params=params, dtype="fp32",
                                                     device="cpu", serving=spec)
        self.off = deepspeed_tpu_torch.init_inference(pmodel, params=params, dtype="fp32",
                                                      device="cpu", serving=srv)

    def configure(self, mode="ngram", k=4, **srv):
        for eng in (self.jax, self.on, self.off):
            s = eng._config.serving
            s.max_num_blocks = srv.get("max_num_blocks", 0)
            s.prefix_caching = srv.get("prefix_caching", "auto")
            s.prefill_chunk_tokens = srv.get("prefill_chunk_tokens", 0)
        for eng in (self.jax, self.on):
            eng._config.serving.speculative.mode = mode
            eng._config.serving.speculative.k = k

    def serve(self, prompts, max_new, **srv):
        """Tokens of the port equal to the JAX engine's and to the port's
        with speculation off; the port's stats equal to the JAX engine's.
        Returns the port's stats."""
        self.configure(**srv)
        want = self.jax.generate_batch(prompts, max_new_tokens=max_new)
        got = self.on.generate_batch(prompts, max_new_tokens=max_new)
        off = self.off.generate_batch(prompts, max_new_tokens=max_new)
        assert len(got) == len(prompts)
        for g, w, o in zip(got, want, off):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            np.testing.assert_array_equal(np.asarray(g), np.asarray(o))
        assert self.on._last_serve_stats == self.jax._last_serve_stats
        return self.on._last_serve_stats, self.off._last_serve_stats


@pytest.fixture(scope="module")
def trio(one_device_mesh):
    return _Trio(TINY)


def _ints(seed, lengths, vocab):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def test_serve_repetitive_identity_and_fewer_fused_steps(trio):
    st, off = trio.serve(_ints(0, (5, 11, 3), 64), 24)
    steps = st["decode_steps"] + st["verify_steps"]
    assert st["verify_steps"] > 0 and st["spec_accepted"] > 0
    assert steps < st["emitted_tokens"] == off["emitted_tokens"]
    assert steps < off["decode_steps"]


def test_serve_midwindow_rejection_and_rollback(trio):
    st, _ = trio.serve(_ints(1, (16, 16, 16), 8), 20)
    assert st["spec_rollbacks"] > 0 and st["spec_accepted"] < st["spec_proposed"]


def test_serve_prefix_cache_off(trio):
    st, _ = trio.serve(_ints(2, (5, 11), 8), 12, prefix_caching="off")
    assert st["verify_steps"] > 0


def test_serve_no_match_falls_back_per_request(trio):
    st, _ = trio.serve([np.arange(1, 11, dtype=np.int32), np.arange(20, 27, dtype=np.int32)], 6)
    assert st["decode_steps"] >= 1


def test_serve_chunked_prefill_interleave(trio):
    st, _ = trio.serve(_ints(3, (4, 30), 8), 14, prefill_chunk_tokens=8)
    assert st["verify_steps"] > 0


def test_serve_auto_is_reserved_and_off(trio):
    st, off = trio.serve(_ints(0, (5,), 64), 6, mode="auto")
    assert st["verify_steps"] == 0 == off["verify_steps"]


def _warnings(monkeypatch):
    from deepspeed_tpu_torch.inference import engine as engine_module
    said = []
    monkeypatch.setattr(engine_module, "warn_once", said.append)
    return said


def test_serve_temperature_disables_speculation(trio, monkeypatch):
    """Sampled serving warns and decodes without speculation in both
    packages (their random streams differ, so only the schedules compare)."""
    trio.configure()
    prompts = _ints(0, (5,), 64)
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=10, seed=3)
    want = trio.jax.generate_batch(prompts, **kw)
    said = _warnings(monkeypatch)
    got = trio.on.generate_batch(prompts, **kw)
    assert any("greedy-only" in m for m in said)
    assert got[0].shape == want[0].shape == (11,)
    assert trio.on._last_serve_stats == trio.jax._last_serve_stats
    assert trio.on._last_serve_stats["verify_steps"] == 0


def test_serve_config_validation_matches_jax(trio):
    prompts = _ints(0, (5,), 64)
    for knobs, match in (({"mode": "bogus"}, "off.ngram.auto"), ({"k": 0}, "speculative.k")):
        trio.configure(**knobs)
        for eng in (trio.jax, trio.on):
            with pytest.raises(ValueError, match=match):
                eng.generate_batch(prompts, max_new_tokens=2)
    trio.configure()


def test_serve_identity_under_eviction_pressure(one_device_mesh):
    """Fresh engines on 5 blocks of 8: the port preempts as often as the JAX
    engine and as the port with speculation off."""
    st, off = _Trio(TINY, max_num_blocks=5).serve(_ints(1, (5, 11), 8), 12, max_num_blocks=5)
    assert st["preemptions"] > 0 and st["preemptions"] == off["preemptions"]


def test_serve_identity_on_the_paged_kernel_path(one_device_mesh):
    """attention_backend "flash": the JAX engine's Pallas paged kernel in
    interpret mode, the port's paged kernel wrapper (its plain version on
    the CPU) once per window position."""
    shape = {**KERNEL_TINY, "attention_backend": "flash"}
    st, _ = _Trio(shape, k=2, block_size=128).serve(_ints(0, (4, 6), 32), 8, k=2)
    assert st["verify_steps"] > 0


def test_static_path_warns_that_speculation_is_ignored(monkeypatch):
    model = CausalLM(TransformerConfig(**TINY))
    eng = deepspeed_tpu_torch.init_inference(
        model, dtype="fp32", device="cpu",
        serving={**BASE, "paged": "off", "speculative": {"mode": "ngram"}})
    said = _warnings(monkeypatch)
    out = eng.generate_batch(_ints(0, (5,), 64), max_new_tokens=3)
    assert out[0].shape == (8,)
    assert any("serving.speculative is ignored" in m for m in said)


def test_ngram_needs_a_model_with_a_verify_step():
    """A model that pages but has no forward_paged_verify is refused with
    speculation on, as in the JAX engine."""
    class NoVerify:
        def __init__(self, model):
            self.config = model.config
            for name in ("init_params", "init_paged_cache", "forward_paged_prefill",
                         "forward_paged_prefill_chunk", "forward_paged_decode"):
                setattr(self, name, getattr(model, name))

    model = NoVerify(CausalLM(TransformerConfig(**TINY)))
    eng = deepspeed_tpu_torch.init_inference(
        model, dtype="fp32", device="cpu", serving={**BASE, "speculative": {"mode": "ngram"}})
    with pytest.raises(ValueError, match="forward_paged_verify"):
        eng.generate_batch(_ints(0, (5,), 64), max_new_tokens=3)
    eng._config.serving.speculative.mode = "off"
    assert eng.generate_batch(_ints(0, (5,), 64), max_new_tokens=3)[0].shape == (8,)
