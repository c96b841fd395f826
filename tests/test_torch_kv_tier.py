"""The port's tiered KV cache against the JAX package's: the counterparts of
``tests/unit/test_serving_kv_tier.py`` (tensor parallelism stays refused in
the port, so its tp=2 case has none).

Host level, each case runs through both packages' classes with the same
calls and compares what they hold (limit 0): the pool's LRU, byte
accounting, geometry guard and fault degradation, with bf16 slabs compared
through a 16-bit integer view; the allocator's demotion and tiered match;
the scheduler's host hits, the copy-on-write (COW) fetch, preempt-before-
fetch and vanished entries, driven by the same fake engine.

Engine level, the JAX and the port engines of ``test_torch_serving_async``
(tiny Llama, fp32, greedy, the same weights) serve the same trace with the
tier on: the scheduler's actions, the tokens, the event order, the serving
counters and the host pool's keys agree (limit 0); the host entries agree
within the model tests' fp32 tolerance (two frameworks' matmuls do not
round alike), and inside the port every fetched block is bit-equal to the
block it spilled (16-bit view, limit 0)."""

import errno
import json
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import block_allocator as jba
from deepspeed_tpu.inference import kv_host_pool as jkhp
from deepspeed_tpu.inference import scheduler as jsch
from deepspeed_tpu.monitor.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu.utils import fault_injection as jax_fi

from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.inference import block_allocator as pba
from deepspeed_tpu_torch.inference import kv_host_pool as pkhp
from deepspeed_tpu_torch.inference import scheduler as psch
from deepspeed_tpu_torch.inference.serve import AsyncServingEngine
from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry
from deepspeed_tpu_torch.utils import fault_injection as fi
from tests.test_torch_serving_async import BASE, pair, run  # noqa: F401

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

SHAPE = (1, 4, 1, 1)        # [L, bs, KV, Hd] of the host-level cases
TOL = 1e-4                  # fp32 k / v across packages (tests/test_torch_model.py)
TIER = {"max_num_blocks": 4, "kv_host": {"enabled": True}}


def _bf16_slab_np(fill):
    return np.full(SHAPE, float(fill), ml_dtypes.bfloat16)


def _bf16_slab_torch(fill):
    return torch.full(SHAPE, float(fill), dtype=torch.bfloat16)


SIDES = {
    "jax": types.SimpleNamespace(
        alloc=jba.BlockAllocator, root=jba.ROOT_KEY, pool=jkhp.KvHostPool,
        sched=jsch.ContinuousBatchingScheduler, tel=jsch.ServingTelemetry, reg=JaxRegistry,
        fi=jax_fi, finished=jsch.FINISHED, dtype="bfloat16", slab=_bf16_slab_np,
        bits=lambda a: np.asarray(a).view(np.int16)),
    "port": types.SimpleNamespace(
        alloc=pba.BlockAllocator, root=pba.ROOT_KEY, pool=pkhp.KvHostPool,
        sched=psch.ContinuousBatchingScheduler, tel=psch.ServingTelemetry, reg=MetricsRegistry,
        fi=fi, finished=psch.FINISHED, dtype=torch.bfloat16, slab=_bf16_slab_torch,
        bits=lambda t: t.view(torch.int16).numpy()),
}


@pytest.fixture(autouse=True)
def no_injector():
    fi.clear()
    jax_fi.clear()
    yield
    fi.clear()
    jax_fi.clear()


def both_sides(scenario):
    """``scenario(S)`` once per package; the observations must agree."""
    got = {name: scenario(S) for name, S in SIDES.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def keys_for(alloc, tokens):
    bs = alloc.block_size
    tokens = np.asarray(tokens, np.int32)
    keys, parent = [], b""
    for j in range(tokens.size // bs):
        parent = alloc.chain_key(parent, tokens[j * bs:(j + 1) * bs])
        keys.append(parent)
    return keys


def pool_state(S, hp):
    return {"keys": hp.keys(), "nbytes": hp.nbytes, "blocks": hp.num_blocks,
            "stats": dict(hp.stats), "problems": hp.consistency_report()}


# --------------------------------------------------------------------- #
# KvHostPool: LRU bound, byte accounting, fault degradation


def test_pool_put_get_roundtrip_bytes_bit_equal():
    def scenario(S):
        hp = S.pool(4, SHAPE, S.dtype)
        assert hp.put(b"a", S.slab(1.5), S.slab(-2.25))
        k, v = hp.get(b"a")
        got = (S.bits(k).tolist(), S.bits(v).tolist())
        # a duplicate put refreshes recency but is not a new spill
        dup = hp.put(b"a", S.slab(9), S.slab(9))
        return {**pool_state(S, hp), "kv_bits": got, "dup": dup,
                "missing": hp.get(b"missing") is None}

    out = both_sides(scenario)
    assert out["blocks"] == 1 and out["nbytes"] == 2 * 2 * int(np.prod(SHAPE))
    assert not out["dup"] and out["missing"] and out["stats"]["fetches"] == 1
    assert out["kv_bits"][0] == _bf16_slab_np(1.5).view(np.int16).tolist()


def test_pool_lru_eviction_at_capacity_and_get_refreshes():
    def scenario(S):
        hp = S.pool(2, SHAPE, S.dtype)
        hp.put(b"a", S.slab(1), S.slab(1))
        hp.put(b"b", S.slab(2), S.slab(2))
        hp.get(b"a")                        # refresh: b is now LRU
        hp.put(b"c", S.slab(3), S.slab(3))  # over capacity: evict b
        return pool_state(S, hp)

    out = both_sides(scenario)
    assert out["keys"] == [b"a", b"c"] and out["stats"]["evictions"] == 1


def test_pool_remove_and_geometry_guard():
    def scenario(S):
        hp = S.pool(4, SHAPE, S.dtype)
        hp.put(b"a", S.slab(1), S.slab(1))
        removed = (hp.remove(b"a"), hp.remove(b"a"))
        wide = S.slab(0).reshape(1, 4, 1, 1).repeat(2, axis=1) if S is SIDES["jax"] \
            else S.slab(0).repeat(1, 2, 1, 1)
        with pytest.raises(ValueError, match="geometry"):
            hp.put(b"x", wide, wide)
        return {**pool_state(S, hp), "removed": removed,
                "geometry": (hp.matches_geometry((2, 4, 1, 1), S.dtype),
                             hp.matches_geometry(SHAPE, S.dtype))}

    out = both_sides(scenario)
    assert out["removed"] == (True, False) and out["nbytes"] == 0
    assert out["geometry"] == (False, True)


def test_pool_spill_fault_degrades_to_noop():
    def scenario(S):
        hp = S.pool(4, SHAPE, S.dtype)
        with S.fi.inject(S.fi.FaultInjector().fail_writes(
                errno.EIO, path_substr="kv_host_pool/spill", count=1)):
            stored = (hp.put(b"a", S.slab(1), S.slab(1)), hp.put(b"b", S.slab(2), S.slab(2)))
        return {**pool_state(S, hp), "stored": stored}

    out = both_sides(scenario)
    assert out["stored"] == (False, True) and out["keys"] == [b"b"]
    assert out["stats"]["errors"] == 1


def test_pool_fetch_fault_drops_entry_reports_miss():
    def scenario(S):
        hp = S.pool(4, SHAPE, S.dtype)
        hp.put(b"a", S.slab(1), S.slab(1))
        with S.fi.inject(S.fi.FaultInjector().fail_writes(
                errno.EIO, path_substr="kv_host_pool/fetch", count=1)):
            miss = hp.get(b"a") is None
        return {**pool_state(S, hp), "miss": miss}

    out = both_sides(scenario)
    assert out["miss"] and out["keys"] == [] and out["stats"]["errors"] == 1
    assert out["problems"] == []


def test_pool_crash_point_inside_a_transfer_propagates():
    """A kill point inside a spill is process death, not a degradable fault."""
    hp = pkhp.KvHostPool(4, SHAPE, torch.bfloat16)
    with fi.inject(fi.FaultInjector(kill_at_byte=10)):
        with pytest.raises(fi.SimulatedCrash):
            hp.put(b"a", _bf16_slab_torch(1), _bf16_slab_torch(1))
    assert hp.stats["errors"] == 0 and hp.num_blocks == 0


# --------------------------------------------------------------------- #
# allocator: demote-instead-of-reclaim and the tiered match walk


def tiered_alloc(S, num_blocks=5, block_size=4, host_cap=8):
    a = S.alloc(num_blocks, block_size, prefix_cache=True)
    hp = S.pool(host_cap, SHAPE, S.dtype)
    a.attach_host_pool(hp)
    spilled = []

    def spill(block, key):
        spilled.append((block, key))
        return hp.put(key, S.slab(block), S.slab(block))

    a.set_spill(spill)
    return a, hp, spilled


def test_reclaim_demotes_instead_of_destroying():
    def scenario(S):
        a, hp, spilled = tiered_alloc(S)
        prompt = np.arange(8, dtype=np.int32)
        blocks = a.allocate(2)
        k0, k1 = keys_for(a, prompt)
        a.register(blocks[0], k0)
        a.register(blocks[1], k1)
        a.free(list(reversed(blocks)))          # both park cold
        got = a.allocate(4)                     # free 2 + reclaim 2
        out = {"got": got, "spilled": spilled, "cold": a.num_cold,
               "match": a.match_prefix(prompt), "tiered": a.match_prefix_tiered(prompt),
               "consistency": a.host_consistency(), **pool_state(S, hp)}
        a.free(got)
        return out

    out = both_sides(scenario)
    k0, k1 = out["tiered"][1]
    assert {k for _, k in out["spilled"]} == {k0, k1} and out["cold"] == 0
    assert out["match"] == ([], []) and out["tiered"][0] == [("host", k0), ("host", k1)]
    assert out["consistency"] == []


def test_tiered_match_mixed_chain_and_break():
    def scenario(S):
        a, hp, _ = tiered_alloc(S, num_blocks=8)
        prompt = np.arange(12, dtype=np.int32)  # 3 full blocks
        k0, k1, _ = keys_for(a, prompt)
        blocks = a.allocate(2)
        a.register(blocks[0], k0)               # block 0 on device
        hp.put(k1, S.slab(7), S.slab(7))        # block 1 demoted
        out = (a.match_prefix_tiered(prompt), blocks[0], k0, k1)
        a.free(blocks)
        return out

    (entries, keys), b0, k0, k1 = both_sides(scenario)
    assert entries == [("dev", b0), ("host", k1)] and keys == [k0, k1]


def test_device_registration_supersedes_host_copy():
    def scenario(S):
        a, hp, _ = tiered_alloc(S)
        k0 = keys_for(a, np.arange(4, dtype=np.int32))[0]
        hp.put(k0, S.slab(1), S.slab(1))
        b = a.allocate(1)[0]
        took = a.register(b, k0)                # a recompute re-landed it
        out = (took, hp.contains(k0), a.host_consistency())
        a.free([b])
        return out

    assert both_sides(scenario) == (True, False, [])


def test_spill_off_reclaim_destroys():
    def scenario(S):
        a, hp, _ = tiered_alloc(S)
        a.set_spill(None)                       # spill: off
        prompt = np.arange(4, dtype=np.int32)
        b = a.allocate(1)
        a.register(b[0], keys_for(a, prompt)[0])
        a.free(b)
        got = a.allocate(4)                     # reclaims the cold block
        out = (hp.num_blocks, a.match_prefix_tiered(prompt))
        a.free(got)
        return out

    assert both_sides(scenario) == (0, ([], []))


def test_host_consistency_flags_double_tier_key():
    def scenario(S):
        a, hp, _ = tiered_alloc(S)
        k0 = keys_for(a, np.arange(4, dtype=np.int32))[0]
        b = a.allocate(1)[0]
        a.register(b, k0)
        # a dropped promote hand-off behind register's back
        hp._entries[k0] = types.SimpleNamespace(k=S.slab(1), v=S.slab(1), nbytes=0,
                                                pending=False)
        probs = a.host_consistency()
        hp._entries.pop(k0)
        a.free([b])
        return probs

    probs = both_sides(scenario)
    assert probs and "exactly one tier" in probs[0]


def test_demote_chain_skips_hot_blocks_and_walks_host_keys():
    """The handoff's push half: cold blocks of the chain demote, a block a
    live request holds stays, host-resident keys extend the walk."""
    def scenario(S):
        a, hp, spilled = tiered_alloc(S, num_blocks=8)
        prompt = np.arange(16, dtype=np.int32)  # 4 full blocks
        k0, k1, k2, _ = keys_for(a, prompt)
        blocks = a.allocate(3)
        for b, k in zip(blocks, (k0, k1, k2)):
            a.register(b, k)
        a.free([blocks[0], blocks[2]])          # blocks[1] stays hot
        n = a.demote_chain(prompt)
        out = {"n": n, "spilled": spilled, "tiered": a.match_prefix_tiered(prompt),
               "again": a.demote_chain(prompt), "consistency": a.host_consistency()}
        a.free([blocks[1]])
        return out

    out = both_sides(scenario)
    assert out["n"] == 2 and out["again"] == 0 and out["consistency"] == []
    assert [e[0] for e in out["tiered"][0]] == ["host", "dev", "host"]


# --------------------------------------------------------------------- #
# scheduler: host hits admit as cache hits whose tail needs only H2D


def make_sched(S, num_blocks=9, block_size=4, max_running=2, n_max=8, telemetry=None,
               host_cap=16, **kw):
    a = S.alloc(num_blocks, block_size, prefix_cache=True)
    hp = S.pool(host_cap, SHAPE, S.dtype)
    a.attach_host_pool(hp)
    a.set_spill(lambda b, key: hp.put(key, S.slab(b), S.slab(b)))
    return S.sched(a, max_running, n_max, telemetry=telemetry, prefix_caching=True, **kw)


def drive(sched, max_steps=400, chunk_tokens=0):
    """Run to completion with fake tokens, doing the engine's fetch and chunk
    bookkeeping (register on landing and drop the host entry, what
    ``_ServeSession._run_fetches`` does without the copies). Returns the
    actions as (kind, rids)."""
    tok, log = 0, []
    for _ in range(max_steps):
        action = sched.next_action()
        if action is None:
            return log
        kind, payload = action
        log.append((kind, [r.rid for r in payload] if isinstance(payload, list)
                    else payload.rid))
        if kind in ("prefill", "prefill_chunk"):
            r = payload
            if r.fetch_pending and sched.telemetry is not None:
                sched.telemetry.kv_fetch_hits.inc(len(r.fetch_pending))
                t = sum(f[4] for f in r.fetch_pending)
                if t:
                    sched.telemetry.kv_fetch_tokens.inc(t)
            for dst, key, _, _, _ in r.fetch_pending:
                if key is not None:
                    sched.allocator.register(dst, key)
                    sched.allocator.host_pool.remove(key)
            r.fetch_pending = []
        if kind == "prefill":
            sched.record_prefill(payload, tok)
            tok += 1
        elif kind == "prefill_chunk":
            r = payload
            r.cow_pending = None
            remaining = r.prefill_target - r.pos
            step = min(chunk_tokens, remaining) if chunk_tokens else remaining
            if r.pos + step == r.prefill_target:
                sched.record_prefill_chunk(r, step, tok)
                tok += 1
            else:
                sched.record_prefill_chunk(r, step)
        else:
            for r in list(payload):
                sched.record_decode(r, tok)
                tok += 1
    raise AssertionError("scheduler did not finish")


def fetches(r):
    return [(f[0], f[1], f[4]) for f in r.fetch_pending]


def test_host_hit_admits_with_fetch_pending():
    def scenario(S):
        reg = S.reg()
        s = make_sched(S, telemetry=S.tel(reg))
        a, hp = s.allocator, s.allocator.host_pool
        prompt = np.arange(10, dtype=np.int32)  # 2 full blocks + tail
        k0, k1 = keys_for(a, prompt)
        hp.put(k0, S.slab(1), S.slab(1))
        hp.put(k1, S.slab(2), S.slab(2))
        r = s.add_request(prompt, max_new=2)
        kind, _ = s.next_action()
        at_admit = {"kind": kind, "pos": r.pos, "target": r.prefill_target,
                    "blocks": list(r.blocks), "fetches": fetches(r), "keys": list(r.keys),
                    "host": (hp.contains(k0), hp.contains(k1)),
                    "counters": dict(reg.snapshot()["counters"])}
        actions = drive(s)
        return {"admit": at_admit, "actions": actions,
                "counters": dict(reg.snapshot()["counters"]),
                "host": (hp.contains(k0), hp.contains(k1)),
                "consistency": a.host_consistency()}

    out = both_sides(scenario)
    adm = out["admit"]
    assert adm["kind"] == "prefill_chunk" and (adm["pos"], adm["target"]) == (8, 10)
    assert [f[0] for f in adm["fetches"]] == adm["blocks"][:2]
    assert adm["host"] == (True, True) and adm["counters"]["serving/kv_fetch_hits"] == 0
    assert adm["counters"]["serving/prefix_cache_hit_tokens"] == 8
    assert out["counters"]["serving/kv_fetch_hits"] == 2
    assert out["counters"]["serving/kv_fetch_tokens"] == 8
    assert out["host"] == (False, False) and out["consistency"] == []


def test_full_prefix_host_hit_cow_fetches_private_copy():
    def scenario(S):
        reg = S.reg()
        s = make_sched(S, telemetry=S.tel(reg))
        a, hp = s.allocator, s.allocator.host_pool
        prompt = np.arange(8, dtype=np.int32)   # exactly 2 full blocks
        k0, k1 = keys_for(a, prompt)
        hp.put(k0, S.slab(1), S.slab(1))
        hp.put(k1, S.slab(2), S.slab(2))
        r = s.add_request(prompt, max_new=2)
        s.next_action()
        adm = {"pos": r.pos, "cow": r.cow_pending, "fetches": fetches(r),
               "last_block": r.blocks[-1], "keys": list(r.keys), "k1_host": hp.contains(k1)}
        actions = drive(s)
        return {"admit": adm, "actions": actions, "k1_dev": a._table.get(k1),
                "k1_host": hp.contains(k1), "counters": dict(reg.snapshot()["counters"]),
                "consistency": a.host_consistency()}

    out = both_sides(scenario)
    adm = out["admit"]
    assert adm["pos"] == 7 and adm["cow"] is None and adm["k1_host"]
    assert adm["fetches"][-1][:2] == (adm["last_block"], None)
    assert out["k1_dev"] == adm["last_block"] and not out["k1_host"]
    assert out["counters"]["serving/kv_fetch_hits"] == 2
    assert out["counters"]["serving/kv_fetch_tokens"] == 7


def test_vanished_host_entry_truncates_chain():
    def scenario(S):
        s = make_sched(S)
        a, hp = s.allocator, s.allocator.host_pool
        prompt = np.arange(10, dtype=np.int32)
        k0, k1 = keys_for(a, prompt)
        hp.put(k0, S.slab(1), S.slab(1))
        hp.put(k1, S.slab(2), S.slab(2))
        with S.fi.inject(S.fi.FaultInjector().fail_writes(
                errno.EIO, path_substr="kv_host_pool/fetch", count=1)):
            r = s.add_request(prompt, max_new=2)
            s.next_action()
        adm = (r.pos, fetches(r), hp.contains(k0), hp.stats["errors"])
        return adm, drive(s), a.host_consistency()

    (pos, fetched, k0_host, errors), _, consistency = both_sides(scenario)
    assert (pos, fetched, k0_host, errors) == (0, [], False, 1) and consistency == []


def test_preempt_before_fetch_loses_nothing():
    def scenario(S):
        s = make_sched(S, num_blocks=5, max_running=1)
        a, hp = s.allocator, s.allocator.host_pool
        k0 = keys_for(a, np.arange(12, dtype=np.int32))[0]
        hp.put(k0, S.slab(1), S.slab(1))
        r = s.add_request(np.arange(12, dtype=np.int32), max_new=2)
        s.next_action()
        adm = (bool(r.fetch_pending), r.pos)
        s._preempt(r)
        after = (r.fetch_pending, r.blocks, hp.contains(k0))
        actions = drive(s)
        return adm, after, actions, r.state == S.finished, a.host_consistency()

    adm, after, _, finished, consistency = both_sides(scenario)
    assert adm == (True, 4) and after == ([], [], True) and finished and consistency == []


def _cow_setup(S, num_blocks):
    s = make_sched(S, num_blocks=num_blocks, max_running=2)
    a, hp = s.allocator, s.allocator.host_pool
    prompt = np.arange(12, dtype=np.int32)      # 3 full blocks
    k0, k1, k2 = keys_for(a, prompt)
    kx = keys_for(a, 63 - prompt[:4])[0]
    blocks = a.allocate(3)
    a.register(blocks[1], k2)                   # the future COW source
    a.register(blocks[2], kx)                   # another cold chain
    hp.put(k0, S.slab(1), S.slab(1))
    hp.put(k1, S.slab(2), S.slab(2))
    return s, a, hp, prompt, blocks, k2


def test_cow_src_pinned_against_fetch_dst_reclaim():
    def scenario(S):
        s, a, hp, prompt, blocks, k2 = _cow_setup(S, 6)
        a.free([blocks[1]])                     # src oldest on the cold LRU
        a.free([blocks[2]])
        a.free([blocks[0]])
        r = s.add_request(prompt, max_new=1)
        kind, _ = s.next_action()
        adm = {"kind": kind, "cow": r.cow_pending, "blocks": list(r.blocks),
               "fetches": fetches(r), "k2": a._table.get(k2), "src_ref": None}
        adm["src_ref"] = a.ref_count(r.cow_pending[0])
        return adm, blocks[1], drive(s), a.host_consistency()

    adm, src, _, consistency = both_sides(scenario)
    assert adm["kind"] == "prefill_chunk" and adm["cow"][0] == src
    assert src not in adm["blocks"] and src not in [f[0] for f in adm["fetches"]]
    assert adm["k2"] == src and adm["src_ref"] == 0 and consistency == []


def test_cow_degrades_to_recompute_when_pool_cannot_pin():
    def scenario(S):
        s, a, hp, prompt, blocks, k2 = _cow_setup(S, 5)
        a.free([blocks[1]])
        a.free([blocks[2]])                     # cold: [src, other]
        r = s.add_request(prompt, max_new=1)
        kind, _ = s.next_action()
        adm = (kind, r.cow_pending, r.pos, len(r.fetch_pending), hp.contains(k2))
        a.free([blocks[0]])                     # release the holdout
        return adm, drive(s), a.host_consistency()

    adm, _, consistency = both_sides(scenario)
    assert adm == ("prefill_chunk", None, 8, 2, True) and consistency == []


# --------------------------------------------------------------------- #
# engines: the port's tiered engine against the JAX one on the same trace


def fresh_side(pair, side, **serving):
    """One package's engine as newly built with the tier on and ``serving``
    over the base config (the pools, the prefix cache, the host tier, the
    rid counter, the recorder and the registry dropped)."""
    eng, _, _, rec, reg = pair.side[side]
    eng._config.serving = type(eng._config.serving)(**{**BASE, **TIER, **serving})
    eng._paged_workspace = eng._paged_alloc = eng._kv_host_pool = None
    eng._serve_rid_base = 0
    rec().clear()
    reg().reset()
    reg().set_enabled(True)
    return eng


def record_spills(engine):
    """Wrap the port pool's ``put`` to keep a copy of every spilled block."""
    hp = engine.ensure_host_kv_pool()
    real, seen = hp.put, {}

    def put(key, k, v):
        ok = real(key, k, v)
        if ok:
            seen[key] = (k.clone(), v.clone())
        return ok

    hp.put = put
    return seen


def bits(t):
    return t.contiguous().view(torch.int16)


def host_entries(hp):
    hp.drain()
    return {key: (np.asarray(e.k, np.float32), np.asarray(e.v, np.float32))
            for key, e in hp._entries.items()}


def tier_both(pair, trace, serving_cfg=None, **kw):
    """The trace through the JAX loop, then the port's, each on a fresh
    tiered engine; asserts they agree on actions, tokens, statuses, event
    order, serving counters and the host pool's keys and entries. Returns
    the port's (loop, handles, record, spilled blocks)."""
    fresh_side(pair, "jax", **(serving_cfg or {}))
    js, _, want = run(pair, "jax", trace, **kw)
    js.shutdown(drain=True)
    fresh_side(pair, "port", **(serving_cfg or {}))
    spilled = record_spills(pair.port)
    serving, hs, got = run(pair, "port", trace, **kw)
    for key in ("status", "tokens", "actions", "events", "restarts", "counters"):
        assert got[key] == want[key], (key, got[key], want[key])
    jent = host_entries(pair.jax._kv_host_pool)
    pent = host_entries(pair.port._kv_host_pool)
    assert list(pent) == list(jent)
    for key in jent:
        for g, w in zip(pent[key], jent[key]):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    return serving, hs, got, spilled


PROMPT = np.arange(16, dtype=np.int32)            # exactly 2 full blocks of 8
SCRATCH = np.random.default_rng(3).integers(0, 64, size=17).astype(np.int32)
REHIT = [("add", PROMPT), ("drive",), ("add", SCRATCH, {"max_new_tokens": 4}), ("drive",),
         ("add", PROMPT), ("drive",)]


def test_demoted_rehit_prefills_only_the_tail(pair):
    """The acceptance case: a fully cached re-admission whose blocks were
    demoted runs no whole-prompt prefill (the tail chunk only), fetches the
    promoted block and the COW copy, and its tokens do not change; every
    fetched block is bit-equal to the block spilled under its key."""
    serving, hs, got, spilled = tier_both(pair, REHIT, max_new=5)
    c = got["counters"]
    assert [a for a in got["actions"] if a[1] == (2,)][0] == ("prefill_chunk", (2,))
    assert not any(a == ("prefill", (2,)) for a in got["actions"])
    assert c["serving/kv_fetch_hits"] == 2 and c["serving/kv_fetch_tokens"] == 15
    assert c["serving/kv_spills"] >= 2 and c["serving/kv_host_errors"] == 0
    assert got["tokens"][0] == got["tokens"][2]
    np.testing.assert_array_equal(hs[2].result(1), pair.ref(PROMPT, 5))
    # the promoted block: on the device under its key, bits as spilled
    alloc = serving._session.sched.allocator
    pools = pair.port._paged_workspace[2]
    k0 = keys_for(alloc, PROMPT)[0]
    block = alloc._table[k0]
    assert torch.equal(bits(pools["k"][:, block]), bits(spilled[k0][0]))
    assert torch.equal(bits(pools["v"][:, block]), bits(spilled[k0][1]))
    # and the entries left in host RAM hold the bits that were spilled
    for key, e in pair.port._kv_host_pool._entries.items():
        assert torch.equal(bits(e.k), bits(spilled[key][0]))
        assert torch.equal(bits(e.v), bits(spilled[key][1]))
    assert alloc.host_consistency() == []


def test_identity_under_eviction_pressure_with_spill(pair):
    ps = [np.random.default_rng(0).integers(0, 64, size=n).astype(np.int32)
          for n in (5, 11, 17)]
    _, hs, got, _ = tier_both(pair, [("add", p) for p in ps] + [("drive",)],
                              {"max_num_blocks": 5, "prefill_chunk_tokens": 8}, max_new=10)
    assert got["counters"]["serving/preemptions"] > 0
    assert got["counters"]["serving/kv_spills"] > 0
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 10))


def test_multiturn_rehit_after_demotion(pair):
    p = np.arange(6, dtype=np.int32)
    turn1 = pair.ref(p, 12)
    turn2 = np.concatenate([turn1, np.asarray([1, 2, 3], np.int32)])
    trace = [("add", p, {"max_new_tokens": 12}), ("drive",),
             ("add", SCRATCH, {"max_new_tokens": 4}), ("drive",),
             ("add", turn2), ("drive",)]
    _, hs, got, _ = tier_both(pair, trace, max_new=4)
    assert got["counters"]["serving/kv_fetch_hits"] > 0
    np.testing.assert_array_equal(hs[2].result(1), pair.ref(turn2, 4))


def test_spill_mode_off_fetches_but_never_demotes(pair):
    _, _, got, _ = tier_both(pair, REHIT, {"kv_host": {"enabled": True, "spill": "off"}},
                             max_new=5)
    assert pair.port._kv_host_pool.num_blocks == 0
    assert got["counters"].get("serving/kv_spills", 0) == 0


def test_generate_batch_rehit_matches_jax(pair):
    """The closed loop: generate_batch, a pressure batch, generate_batch
    again, on each package's engine; rows and counters agree."""
    outs = {}
    for side in ("jax", "port"):
        eng = fresh_side(pair, side)
        rows = [eng.generate_batch([PROMPT], max_new_tokens=5)[0],
                eng.generate_batch([SCRATCH], max_new_tokens=4)[0],
                eng.generate_batch([PROMPT], max_new_tokens=5)[0]]
        c = eng.telemetry_snapshot()["counters"]
        outs[side] = ([np.asarray(r).tolist() for r in rows],
                      {k: v for k, v in c.items() if k.startswith("serving/")},
                      eng._kv_host_pool.keys())
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["serving/kv_fetch_hits"] == 2


# --------------------------------------------------------------------- #
# fault degradation: the serving loop never wedges


def _faulted_both(pair, trace, path_substr, serving_cfg=None, **kw):
    """``tier_both`` with a persistent I/O fault on ``path_substr``."""
    out = {}
    for side in ("jax", "port"):
        fim = pair.side[side][2]
        fresh_side(pair, side, **(serving_cfg or {}))
        with fim.inject(fim.FaultInjector().fail_writes(errno.EIO, path_substr=path_substr,
                                                        count=-1)):
            serving, hs, rec = run(pair, side, trace, **kw)
        out[side] = (serving, hs, rec)
    for key in ("status", "tokens", "actions", "events", "counters"):
        assert out["port"][2][key] == out["jax"][2][key], key
    return out["port"]


def test_spill_faults_degrade_to_destroy(pair):
    ps = [np.random.default_rng(0).integers(0, 64, size=n).astype(np.int32)
          for n in (5, 11, 17)]
    _, hs, rec = _faulted_both(pair, [("add", p) for p in ps] + [("drive",)],
                               "kv_host_pool/spill", {"max_num_blocks": 5}, max_new=10)
    c = rec["counters"]
    assert c["serving/kv_host_errors"] > 0 and c.get("serving/kv_spills", 0) == 0
    assert pair.port._kv_host_pool.num_blocks == 0
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 10))


def test_fetch_faults_degrade_to_recompute(pair):
    serving, hs, rec = _faulted_both(pair, REHIT, "kv_host_pool/fetch", max_new=5)
    assert rec["counters"]["serving/kv_host_errors"] > 0
    assert rec["counters"]["serving/kv_fetch_hits"] == 0
    assert ("prefill", (2,)) in rec["actions"]          # recomputed whole
    np.testing.assert_array_equal(hs[2].result(1), hs[0].result(1))
    assert serving._session.sched.allocator.host_consistency() == []


def test_threaded_loop_with_io_faults_drains_cleanly(pair):
    """The loop on its serving thread, tier on, every spill and fetch
    faulted: each handle ends with the JAX engine's greedy tokens and the
    loop drains without leaking a block."""
    rng = np.random.default_rng(1)
    ps = [rng.integers(0, 64, size=n).astype(np.int32) for n in (5, 11, 17)]
    eng = fresh_side(pair, "port", max_num_blocks=5)
    with fi.inject(fi.FaultInjector().fail_writes(errno.EIO, path_substr="kv_host_pool",
                                                  count=-1)):
        loop = AsyncServingEngine(eng, max_new_tokens=8)
        handles = [loop.add_request(p) for p in ps]
        outs = [h.result(timeout=60) for h in handles]
        loop.shutdown(drain=True)
    for o, p in zip(outs, ps):
        np.testing.assert_array_equal(o, pair.ref(p, 8))
    assert eng.telemetry_snapshot()["counters"]["serving/kv_host_errors"] > 0
    assert eng._paged_alloc.leak_report() == {}


# --------------------------------------------------------------------- #
# the loop's demote command and the kv_spill knob


def test_request_demote_pushes_a_cold_prompt_into_the_host_tier(pair):
    """``request_demote`` runs on the loop between steps and sets its event;
    the re-admission then fetches what was demoted. The JAX loop demotes
    the same keys."""
    keys = {}
    for side in ("jax", "port"):
        eng, mod = fresh_side(pair, side), pair.side[side][1]
        serving = mod.AsyncServingEngine(eng, max_new_tokens=3, start=False)
        h = serving.add_request(PROMPT)
        while serving.step():
            pass
        done = serving.request_demote(PROMPT)
        assert not done.is_set()
        serving.step()
        assert done.is_set()
        keys[side] = eng._kv_host_pool.keys()
        h2 = serving.add_request(PROMPT)
        while serving.step():
            pass
        serving.shutdown(drain=True)
        assert h2.generated == h.generated
    assert keys["port"] == keys["jax"] and len(keys["port"]) == 2
    c = pair.port.telemetry_snapshot()["counters"]
    assert c["serving/kv_fetch_hits"] == 2
    stopped = AsyncServingEngine(fresh_side(pair, "port"), max_new_tokens=3, start=False)
    stopped.shutdown()
    assert stopped.request_demote(PROMPT).is_set()      # a stopped loop never strands it


def test_kv_spill_knob_moves_the_spill_hook(pair):
    eng = fresh_side(pair, "port")
    serving = AsyncServingEngine(eng, max_new_tokens=3, start=False)
    alloc = serving._session.sched.allocator
    assert alloc._spill_fn is not None
    serving.apply_knobs([{"knob": "kv_spill", "value": 0}])
    serving.step()
    assert alloc._spill_fn is None and not serving._session._kv_spill
    serving.apply_knobs([{"knob": "kv_spill", "value": 1}])
    serving.step()
    assert alloc._spill_fn is not None
    serving.shutdown()
    assert alloc._spill_fn is None                      # close clears the hook


# --------------------------------------------------------------------- #
# surfaces: events, trace, gauges, health pane


def test_spill_fetch_events_and_trace_validate(pair, tmp_path):
    _, _, got, _ = tier_both(pair, REHIT, max_new=5)
    events = pair.port._events.snapshot()
    sp = next(e for e in events if e.kind == "kv.spill")
    assert sp.data["blocks"] == 1 and sp.data["bytes"] > 0
    assert sp.dur_ns is not None and sp.rid is None
    ft = next(e for e in events if e.kind == "kv.fetch")
    assert ft.rid == 2 and ft.dur_ns is not None
    assert ft.data["blocks"] == 2 and ft.data["bytes"] == 2 * sp.data["bytes"]
    validator = cli.load_validator()
    jl = str(tmp_path / "events.jsonl")
    pair.port._events.write_jsonl(jl)
    assert validator.validate_path(jl, kind="events") == []
    tr = str(tmp_path / "trace.json")
    pair.port.export_serving_trace(tr)
    assert validator.validate_path(tr, kind="chrome") == []
    names = {e.get("name") for e in json.load(open(tr))["traceEvents"]}
    assert "kv_spill" in names and "kv_fetch" in names


def test_telemetry_gauges_and_health_pane(pair):
    from deepspeed_tpu_torch.monitor.health import health_summary, render_health_table
    tier_both(pair, REHIT, max_new=5)
    snap = pair.port.telemetry_snapshot()
    g, c = snap["gauges"], snap["counters"]
    assert g["serving/kv_host_blocks"] == pair.port._kv_host_pool.num_blocks
    assert g["serving/kv_host_bytes"] == pair.port._kv_host_pool.nbytes
    sv = health_summary(snap)["serving"]
    assert sv["kv_spills"] == c["serving/kv_spills"] > 0
    assert sv["kv_fetch_hits"] == c["serving/kv_fetch_hits"] > 0
    table = render_health_table(snap)
    assert "host" in table and "H/" in table
