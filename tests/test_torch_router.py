"""The port's replica router against the JAX package's: the counterparts of
``tests/unit/test_serving_router.py``.

Two JAX engines and two port engines (tiny Llama, fp32, greedy, the same
weights; each package's second engine built on its first one's weight tree)
serve the same request traces behind each package's ``ReplicaRouter``,
driven synchronously (``start=False`` and ``router.step()``): the routing
``decisions`` agree byte for byte, and so do the tokens and statuses. The
cases cover session affinity and its prefix-cache re-hit, the least-loaded
tiebreak, N=2 against N=1, the prefill-to-decode handoff through the shared
host KV tier (the decode replica never prefills a whole prompt), the
breaker drain with suffix-only forwarding, all replicas down, the health
pane and the ``serve.route`` events in a fleet trace that validates. The
compile-budget contract of the JAX suite has no counterpart: the port
compiles nothing per shape."""

import http.client
import json
import threading
import types

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference import router as jax_router
from deepspeed_tpu.inference import serve as jax_serve
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.monitor.events import get_flight_recorder as jax_recorder
from deepspeed_tpu.monitor.metrics import get_registry as jax_registry
from deepspeed_tpu.utils import fault_injection as jax_fi

import deepspeed_tpu_torch
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference import router
from deepspeed_tpu_torch.inference import serve
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor.events import get_flight_recorder
from deepspeed_tpu_torch.monitor.metrics import get_registry
from deepspeed_tpu_torch.utils import fault_injection as fi
from tests.test_torch_serving_async import LLAMA

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

BASE = {"block_size": 8, "max_running": 2}
DRAIN = {"fault": {"max_engine_restarts": 1, "restart_backoff_s": 0.0}}
HANDOFF = {"prefix_caching": "on", "kv_host": {"enabled": True}}


class Fleet:
    """Two JAX and two port engines over the same weights, telemetry and
    events on, and each package's modules."""

    def __init__(self):
        jmodel = JaxCausalLM(JT.TransformerConfig(remat=False, **LLAMA))
        jparams = jax.tree.map(np.asarray, JT.init_params(jmodel.config, jax.random.key(7)))
        pmodel = CausalLM(TransformerConfig(**LLAMA))
        pparams = params_from_jax(pmodel.config, jparams)
        tel = {"enabled": True, "events": True}
        j0 = deepspeed_tpu.init_inference(jmodel, params=jparams, dtype="fp32", serving=BASE,
                                          telemetry=tel)
        j1 = deepspeed_tpu.init_inference(jmodel, params=j0.params, dtype="fp32", serving=BASE,
                                          telemetry=tel)
        p0 = deepspeed_tpu_torch.init_inference(pmodel, params=pparams, dtype="fp32",
                                                device="cpu", serving=BASE, telemetry=tel)
        p1 = deepspeed_tpu_torch.init_inference(pmodel, params=p0.params, dtype="fp32",
                                                device="cpu", serving=BASE, telemetry=tel)
        self.side = {
            "jax": types.SimpleNamespace(engines=[j0, j1], router=jax_router, serve=jax_serve,
                                         fi=jax_fi, rec=jax_recorder, reg=jax_registry),
            "port": types.SimpleNamespace(engines=[p0, p1], router=router, serve=serve,
                                          fi=fi, rec=get_flight_recorder, reg=get_registry)}
        self._refs = {}

    def ref(self, prompt, max_new):
        """The JAX engine's closed-loop greedy row for one prompt."""
        key = (tuple(int(t) for t in prompt), max_new)
        if key not in self._refs:
            self._refs[key] = np.asarray(self.side["jax"].engines[0].generate(
                np.asarray(prompt)[None, :], max_new_tokens=max_new))[0]
        return self._refs[key]


@pytest.fixture(scope="module")
def fleet():
    f = Fleet()
    yield f
    for S in f.side.values():
        S.rec().clear()
        S.reg().reset()


def reset(fleet, side, **serving):
    """The side's engines as newly built with ``serving`` over the base
    config; its recorder and registry cleared."""
    S = fleet.side[side]
    for eng in S.engines:
        eng._config.serving = type(eng._config.serving)(**{**BASE, **serving})
        eng._paged_workspace = eng._paged_alloc = eng._kv_host_pool = None
        eng._serve_rid_base = 0
    S.rec().clear()
    S.reg().reset()
    S.reg().set_enabled(True)
    return S


def make_router(S, max_new=8, share_pool=False, **kw):
    if share_pool:
        S.engines[1].adopt_host_kv_pool(S.engines[0].ensure_host_kv_pool())
    loops = [S.serve.AsyncServingEngine(e, max_new_tokens=max_new, start=False)
             for e in S.engines]
    try:
        return S.router.ReplicaRouter(loops, **kw)
    except ValueError:
        for loop in loops:                  # release the engines' sessions
            loop.shutdown()
        raise


def drive(r):
    n = 0
    while r.step():
        n += 1
        assert n < 2000, "router did not converge"


def prompts(lens=(5, 11, 3, 8), vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def both(fleet, scenario, serving=None):
    """``scenario(S)`` on each package after a reset; the records agree."""
    out = {}
    for side in ("jax", "port"):
        out[side] = scenario(reset(fleet, side, **(serving or {})))
    assert out["port"] == out["jax"], (out["port"], out["jax"])
    return out["port"]


def record(r, hs):
    return {"decisions": list(r.decisions), "tokens": [h.generated for h in hs],
            "status": [h.status for h in hs]}


# --------------------------------------------------------------------- #
# deterministic routing


def test_decisions_equal_the_jax_routers_and_replay(fleet):
    """The determinism pin: one trace through both packages' routers gives
    the same ``decisions`` byte for byte, and the port's replay gives the
    same again."""
    trace = list(zip(prompts((5, 11, 3, 8, 6)), ["alice", None, "bob", "alice", None]))

    def scenario(S):
        runs = []
        for _ in range(2):
            r = make_router(S)
            hs = [r.add_request(p, session=s) for p, s in trace]
            drive(r)
            runs.append(record(r, hs))
            r.shutdown()
        assert runs[0] == runs[1]
        return runs[0]

    rec = both(fleet, scenario)
    assert rec["status"] == ["finished"] * 5
    assert {d["reason"] for d in rec["decisions"]} == {"affinity", "least_loaded"}
    for (p, _), toks in zip(trace, rec["tokens"]):
        assert toks == fleet.ref(p, 8)[p.size:].tolist()


def test_least_loaded_spreads_and_index_breaks_ties(fleet):
    def scenario(S):
        r = make_router(S)
        hs = [r.add_request(p) for p in prompts((5, 5))]
        at_submit = [(d["replica"], d["reason"]) for d in r.decisions]
        drive(r)
        r.shutdown()
        return at_submit, record(r, hs)

    at_submit, rec = both(fleet, scenario)
    assert at_submit == [("r0", "least_loaded"), ("r1", "least_loaded")]
    assert rec["status"] == ["finished", "finished"]


def test_affinity_pins_session_to_one_replica(fleet):
    def scenario(S):
        r = make_router(S)
        hs = []
        for turn in range(3):
            hs.append(r.add_request(prompts((7,))[0], session="conv-1"))
            hs.append(r.add_request(prompts((5,), seed=turn + 1)[0]))
            drive(r)
        r.shutdown()
        return record(r, hs)

    rec = both(fleet, scenario)
    conv = [d for d in rec["decisions"] if d["session"] == "conv-1"]
    assert len(conv) == 3 and len({d["replica"] for d in conv}) == 1
    assert {d["reason"] for d in conv} == {"affinity"}
    assert rec["status"] == ["finished"] * 6


@pytest.mark.parametrize("serving,kw,want", [
    ({"replicas": {"affinity": "off"}}, {}, "least_loaded"),
    ({"replicas": {"roles": ["prefill"]}}, {}, ["prefill", "any"]),
    ({}, {"roles": ["prefill", "prefill"]}, "decode-capable"),
])
def test_config_resolves_affinity_and_roles(fleet, serving, kw, want):
    """``serving.replicas`` seeds affinity and the role split without a
    constructor argument (short role lists pad with "any"); a fleet with no
    decode-capable replica is refused, in both packages alike."""
    def scenario(S):
        try:
            r = make_router(S, **kw)
        except ValueError as e:
            return str(e)
        r.add_request(prompts((5,))[0], session="alice")
        out = (r.roles, r._prefill_idx, r._serving_idx, r.decisions[0]["reason"])
        drive(r)
        r.shutdown()
        return out

    out = both(fleet, scenario, serving)
    if isinstance(want, list):
        assert out[:3] == (want, [0], [1])
    elif want == "least_loaded":
        assert out[3] == "least_loaded"
    else:
        assert want in out


def test_second_turn_rehits_affine_prefix_cache(fleet):
    """Multi-turn: turn 2 (turn 1's prompt and reply) re-hits the prefix
    cache turn 1 built on the affine replica, read through the
    ``serving/prefix_cache_hit_tokens`` counter."""
    def scenario(S):
        r = make_router(S)
        prompt = prompts((17,))[0]
        h1 = r.add_request(prompt, session="conv-1")
        drive(r)
        turn2 = np.concatenate([prompt, np.asarray(h1.generated, np.int32)])
        before = S.reg().snapshot()["counters"].get("serving/prefix_cache_hit_tokens", 0)
        h2 = r.add_request(turn2, session="conv-1")
        drive(r)
        hit = S.reg().snapshot()["counters"]["serving/prefix_cache_hit_tokens"] - before
        r.shutdown()
        return record(r, [h1, h2]), hit, int(turn2.size)

    rec, hit, n2 = both(fleet, scenario, {"prefix_caching": "on"})
    assert hit >= (n2 // 8) * 8 - 8 and hit > 0
    assert len({d["replica"] for d in rec["decisions"]}) == 1


# --------------------------------------------------------------------- #
# N=2 against N=1, the handle surface, one weight tree


def test_replicas_share_one_weight_tree(fleet):
    p0, p1 = fleet.side["port"].engines
    pairs = list(zip(p0.params.parameters(), p1.params.parameters()))
    assert pairs and all(a.data_ptr() == b.data_ptr() for a, b in pairs)


def test_n2_token_identical_to_n1(fleet):
    """The scale-out pin: the same trace through one always-on loop and
    through a 2-replica router gives the same greedy tokens per request,
    and both replicas served."""
    S = reset(fleet, "port")
    sessions = [f"sess{i}" for i in range(4)]
    one = S.serve.AsyncServingEngine(S.engines[0], max_new_tokens=8, start=False)
    hs = [one.add_request(p, session=s) for p, s in zip(prompts(), sessions)]
    while one.step():
        pass
    ref = [h.generated for h in hs]
    one.shutdown()
    S = reset(fleet, "port")
    r = make_router(S)
    hs2 = [r.add_request(p, session=s) for p, s in zip(prompts(), sessions)]
    drive(r)
    assert [h.generated for h in hs2] == ref
    assert ref == [fleet.ref(p, 8)[p.size:].tolist() for p in prompts()]
    assert len({d["replica"] for d in r.decisions}) == 2
    assert r.health_state()[0] == 200
    r.shutdown()
    code, body = r.health_state()
    assert code == 503 and body["state"] == "stopped"


def test_handle_result_stream_and_cancel(fleet):
    S = reset(fleet, "port")
    r = make_router(S)
    p = prompts((5,))[0]
    h = r.add_request(p)
    t = threading.Thread(target=drive, args=(r,), daemon=True)
    t.start()
    full = h.result(timeout=120)
    t.join(120)
    assert isinstance(h, router.RouterHandle)
    np.testing.assert_array_equal(full, fleet.ref(p, 8))
    hc = r.add_request(prompts((6,))[0])
    hc.cancel()
    drive(r)
    assert hc.status in ("cancelled", "finished")
    r.shutdown()


# --------------------------------------------------------------------- #
# the prefill-to-decode handoff over the shared host KV tier


def test_decode_replica_never_runs_whole_prompt_prefill(fleet):
    """The disaggregation pin: roles prefill, decode and one host pool; the
    decode replica serves the request with no whole-prompt prefill (its
    prefill work is the tail under one block), every full block arrives
    through the host tier, and the tokens are the single engine's."""
    prompt = prompts((21,), seed=1)[0]

    def scenario(S):
        r = make_router(S, share_pool=True, roles=["prefill", "decode"])
        sp = r.replicas[0]
        h = r.add_request(prompt)
        assert h._stage == "warm"
        n = 0
        while h._stage in ("warm", "demote") and n < 200:
            sp.step()                       # the prefill replica alone
            r._advance(h)
            n += 1
        assert h._stage == "running"
        fetch0 = S.reg().snapshot()["counters"].get("serving/kv_fetch_hits", 0)
        mark = len(S.rec().snapshot())
        drive(r)
        got = h.result()
        c = S.reg().snapshot()["counters"]
        decode_prefills = [e.data["tokens"] for e in S.rec().snapshot()[mark:]
                           if e.kind in ("req.prefill", "req.prefill_chunk")]
        r.shutdown()
        for s in r.replicas:
            assert s._session.sched.allocator.host_consistency() == []
        return {**record(r, [h]), "row": got.tolist(),
                "fetched": c["serving/kv_fetch_hits"] - fetch0,
                "handoffs": c["router/handoffs"], "decode_prefills": decode_prefills}

    rec = both(fleet, scenario, HANDOFF)
    assert [(d["replica"], d["reason"]) for d in rec["decisions"]] == \
        [("r1", "handoff"), ("r0", "prefill")]
    assert rec["row"] == fleet.ref(prompt, 8).tolist()
    assert rec["fetched"] == prompt.size // 8 and rec["handoffs"] == 1
    assert rec["decode_prefills"] and max(rec["decode_prefills"]) < prompt.size


@pytest.mark.parametrize("serving,length", [
    (HANDOFF, 5), ({**HANDOFF, "replicas": {"handoff": "off"}}, 21)])
def test_handoff_skipped_below_a_block_and_when_off(fleet, serving, length):
    """A prompt under one block has nothing to ship, and ``handoff: off``
    keeps the roles but never warms: both route plainly."""
    def scenario(S):
        r = make_router(S, share_pool=True, roles=["prefill", "decode"])
        h = r.add_request(prompts((length,))[0])
        stage = h._stage
        drive(r)
        r.shutdown()
        return stage, record(r, [h])

    stage, rec = both(fleet, scenario, serving)
    assert stage == "running" and rec["status"] == ["finished"]
    assert [d["reason"] for d in rec["decisions"]] == ["least_loaded"]


# --------------------------------------------------------------------- #
# breaker-tripped fault drain


def trip(S, r, idx=0, handles=()):
    """Step replica ``idx`` alone under a persistent engine-fatal decode
    fault until its crash-loop breaker opens."""
    with S.fi.inject(S.fi.FaultInjector().fail_step("decode", count=-1, phase="post")):
        n = 0
        while not r.replicas[idx]._crash_loop and n < 300:
            r.replicas[idx].step()
            for h in handles:
                r._advance(h)
            n += 1
    assert r.replicas[idx]._crash_loop


def test_drain_completes_on_the_sibling_token_identical(fleet):
    """The fault-drain pin: r0's breaker opens with requests queued and
    running; each completes on r1 with the single engine's tokens (only
    the unseen suffix forwarded), r0's /healthz reads 503 while the
    router's reads 200 over HTTP, and the drain is counted and evented."""
    ps = prompts((5, 11, 7))
    ports = {}

    def scenario(S):
        r = make_router(S)
        server = S.serve.build_http_server(r, port=0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            hs = [r.add_request(p) for p in ps]
            trip(S, r)
            drive(r)
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            health = (resp.status, json.loads(resp.read()))
        finally:
            server.shutdown()
            t.join(60)
        from deepspeed_tpu_torch.monitor.health import labeled_series
        drained = labeled_series(S.reg().snapshot()["counters"], "router/drained_requests")
        kinds = [e.kind for e in S.rec().snapshot()]
        ports[S.router.__name__] = (health, r.replicas[0].health_state(), drained, kinds)
        rec = record(r, hs)
        r.shutdown()
        return rec

    rec = both(fleet, scenario, DRAIN)
    assert rec["status"] == ["finished"] * 3
    for toks, p in zip(rec["tokens"], ps):
        assert toks == fleet.ref(p, 8)[p.size:].tolist()
    failover = [d for d in rec["decisions"] if d["reason"] == "failover"]
    assert failover and {d["replica"] for d in failover} == {"r1"}
    (status, body), (c0, b0), drained, kinds = ports[router.__name__]
    assert status == 200 and body["state"] == "serving" and body["healthy_replicas"] == 1
    assert body["replicas"]["r0"]["state"] == "crash_loop"
    assert c0 == 503 and b0["state"] == "crash_loop"
    n_r0 = sum(1 for d in rec["decisions"] if d["replica"] == "r0")
    assert drained.get("r0") == n_r0 > 0 and "serve.drain" in kinds


def test_new_traffic_avoids_tripped_replica(fleet):
    def scenario(S):
        r = make_router(S, **{})
        h0 = r.add_request(prompts((5,))[0])
        trip(S, r, handles=(h0,))
        h1 = r.add_request(prompts((7,))[0], session="sess0")   # hashes onto r0
        drive(r)
        r.shutdown()
        return record(r, [h0, h1])

    rec = both(fleet, scenario, {"fault": {"max_engine_restarts": 0, "restart_backoff_s": 0.0}})
    assert rec["status"] == ["finished", "finished"]
    assert (rec["decisions"][-1]["reason"], rec["decisions"][-1]["replica"]) == \
        ("failover", "r1")


def test_all_replicas_down_add_request_raises(fleet):
    def scenario(S):
        r = make_router(S)
        with S.fi.inject(S.fi.FaultInjector().fail_step("decode", count=-1, phase="post")):
            hs = [r.add_request(p) for p in prompts((5, 7))]
            drive(r)
        with pytest.raises(S.serve.RequestFailed):
            hs[0].result(1)
        with pytest.raises(RuntimeError, match="no healthy replica"):
            r.add_request(prompts((5,))[0])
        code, body = r.health_state()
        r.shutdown()
        return record(r, hs), code, body["state"]

    rec, code, state = both(fleet, scenario,
                            {"fault": {"max_engine_restarts": 0, "restart_backoff_s": 0.0}})
    assert rec["status"] == ["error", "error"] and (code, state) == (503, "crash_loop")


# --------------------------------------------------------------------- #
# observability: the replicas pane, route events, the fleet trace


def test_health_summary_replicas_section_and_pane(fleet):
    from deepspeed_tpu_torch.monitor.health import health_summary, render_summary_table
    S = reset(fleet, "port")
    r = make_router(S)
    hs = [r.add_request(p, session=s)
          for p, s in zip(prompts((5, 7, 6)), ["sess0", "sess1", None])]
    drive(r)
    assert all(h.status == "finished" for h in hs)
    reps = health_summary(get_registry().snapshot())["replicas"]
    assert set(reps["requests"]) == {"r0", "r1"} and sum(reps["requests"].values()) == 3
    assert reps["healthy"] == {"r0": 1, "r1": 1}
    table = render_summary_table(health_summary(get_registry().snapshot()))
    assert "r0 up" in table and "r1 up" in table
    r.shutdown()
    table = render_summary_table(health_summary(get_registry().snapshot()))
    assert "r0 DOWN" in table and "r1 DOWN" in table


def test_route_events_and_fleet_trace_validate(fleet, tmp_path):
    """Every decision lands a ``serve.route`` event (seq, replica, reason,
    session), as the JAX router's do; the serving trace and the fleet trace
    of a handoff run validate."""
    kinds = {}

    def scenario(S):
        r = make_router(S, share_pool=True, roles=["prefill", "decode"])
        hs = [r.add_request(p, session=s)
              for p, s in zip(prompts((5, 21)), ["alice", None])]
        drive(r)
        routes = [(e.data["seq"], e.data["replica"], e.data["reason"], e.data["session"])
                  for e in S.rec().snapshot() if e.kind == "serve.route"]
        kinds[S.router.__name__] = r
        return record(r, hs), routes

    rec, routes = both(fleet, scenario, HANDOFF)
    assert [x[2] for x in routes] == [d["reason"] for d in rec["decisions"]]
    assert routes[0][3] == "alice" and [x[0] for x in routes] == list(range(len(routes)))
    r = kinds[router.__name__]
    validator = cli.load_validator()
    path = str(tmp_path / "serving.json")
    r.engine.export_serving_trace(path)
    assert validator.validate_path(path, kind="chrome") == []
    assert any(e.get("name") == "route" for e in json.load(open(path))["traceEvents"])
    fleet_path = r.export_fleet_trace(str(tmp_path / "fleet.json"))
    assert validator.validate_path(fleet_path, kind="chrome") == []
    for rr in kinds.values():
        rr.shutdown()
