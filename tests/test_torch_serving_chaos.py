"""The port's serving fault containment against the JAX package's: the
counterparts of ``tests/unit/test_serving_chaos.py`` (the ``fail_step``
injector, per-request containment with logical-step backoff and
quarantine, engine-fatal recovery and the crash-loop breaker, deadlines,
load shedding, the fault events and health rows, and the graceful SIGTERM
drain of ``serve``).

Each trace and injection schedule runs through the JAX
``AsyncServingEngine(start=False)`` and the port's (the harness of
``test_torch_serving_async.py``: one JAX and one port engine for the
module, tiny Llama, fp32, greedy): tokens through every fault class,
statuses, scheduler actions, event order and serving counters agree (limit
0), the tiered KV cache's spill and fetch faults included; the HTTP and
signal cases run the port's server and hold it to the JAX engine's
closed-loop tokens."""

import http.client
import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.utils import fault_injection as jax_fi

from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.inference import serve
from deepspeed_tpu_torch.inference.block_allocator import BlockAllocator
from deepspeed_tpu_torch.inference.policy import SchedulingPolicy
from deepspeed_tpu_torch.inference.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.utils import fault_injection as fi
from tests.test_torch_serving_async import both, drive, fresh, pair, prompts  # noqa: F401

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


@pytest.fixture(autouse=True)
def no_injector():
    fi.clear()
    jax_fi.clear()
    yield
    fi.clear()
    jax_fi.clear()


# --------------------------------------------------------------------- #
# FaultInjector.fail_step (both injectors, the same calls)


def _both_injectors(build, consults):
    """Run ``consults`` ((kind, phase, tick) triples) through an injector of
    each package; the raised messages (or None) must agree."""
    outs = []
    for mod in (jax_fi, fi):
        inj = build(mod.FaultInjector())
        seen = []
        for kind, phase, tick in consults:
            try:
                inj.on_step(kind, phase, tick)
                seen.append(None)
            except Exception as e:  # noqa: BLE001
                seen.append(f"{type(e).__name__}: {e}")
        outs.append((seen, inj.steps_seen))
    assert outs[0] == outs[1]
    return outs[1]


def test_kind_step_and_count_matching():
    seen, _ = _both_injectors(lambda i: i.fail_step("decode", at_step=3, count=2), [
        ("prefill", "pre", True), ("decode", "pre", True), ("decode", "pre", True),
        ("prefill", "pre", True), ("decode", "pre", True), ("decode", "pre", True)])
    assert [s is not None for s in seen] == [False, False, True, False, True, False]
    assert "decode, step 3" in seen[2]


def test_persistent_and_any_kind():
    seen, _ = _both_injectors(lambda i: i.fail_step(count=-1), [
        (k, "pre", True) for k in ("prefill", "decode", "verify")])
    assert all(seen)


def test_phase_gating_and_custom_exc():
    seen, _ = _both_injectors(
        lambda i: i.fail_step("decode", exc=ValueError("poison"), phase="post"),
        [("decode", "pre", True), ("decode", "post", False)])
    assert seen == [None, "ValueError: poison"]
    with pytest.raises(ValueError, match="'pre' or 'post'"):
        fi.FaultInjector().fail_step("decode", phase="mid")


def test_tick_only_advances_on_action_consults():
    _, steps = _both_injectors(lambda i: i, [("prefill", "pre", True), ("cow", "pre", False),
                                             ("prefill", "post", False)])
    assert steps == 1


def test_step_fault_gate_is_noop_without_injector():
    fi.clear()
    fi.step_fault("decode", "pre", tick=True)


# --------------------------------------------------------------------- #
# per-request containment


def _faults(*specs):
    return [dict(zip(("kind", "at_step", "count", "phase"), s)) for s in specs]


@pytest.mark.parametrize("kind,serving_cfg", [
    ("prefill", {}), ("decode", {}), ("prefill_chunk", {"prefill_chunk_tokens": 4})])
def test_fault_at_pinned_step_token_identity(pair, kind, serving_cfg):
    ps = prompts((5, 11, 3))
    _, hs, got, _ = both(pair, [("add", p) for p in ps] + [("drive",)], serving_cfg,
                         faults=_faults((kind, 4, 1, "pre")))
    assert got["status"] == ["finished"] * 3
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 8))


def test_verify_fault_token_identity(pair):
    rng = np.random.default_rng(1)
    prompt = np.tile(rng.integers(0, 8, size=8).astype(np.int32), 3)
    _, hs, _, _ = both(pair, [("add", prompt), ("drive",)],
                       {"speculative": {"mode": "ngram", "k": 4}}, max_new=12,
                       faults=_faults(("verify", None, 1, "pre")))
    np.testing.assert_array_equal(hs[0].result(1), pair.ref(prompt, 12))


def test_cow_fault_token_identity_on_cache_rehit(pair):
    """A copy-on-write fault on a full-prefix cache re-hit re-queues the
    request, which completes identically; the fault counts at the cow site."""
    prompt = prompts((8,))[0]

    trace = [("add", prompt), ("drive",), ("add", prompt), ("drive",)]
    _, hs, got, _ = both(pair, trace, max_new=6, faults=_faults(("cow", None, 1, "pre")))
    assert got["status"] == ["finished", "finished"]
    np.testing.assert_array_equal(hs[1].result(1), pair.ref(prompt, 6))
    assert got["counters"]['serving/step_faults{kind="cow"}'] == 1
    assert ("prefill_chunk", (1,)) in got["actions"]


TIER = {"max_num_blocks": 4, "kv_host": {"enabled": True}}
TIER_PROMPT = np.arange(16, dtype=np.int32)
TIER_SCRATCH = np.arange(30, 47, dtype=np.int32)


def test_spill_step_faults_degrade_on_tiered_engine(pair):
    """An injected spill step fault degrades to destroy-on-reclaim (counted
    in kv_host_errors, never a containment retry): the loop drains clean
    and the tokens do not change."""
    trace = [("add", TIER_PROMPT), ("drive",), ("add", TIER_SCRATCH, {"max_new_tokens": 4}),
             ("drive",)]
    serving, hs, got, _ = both(pair, trace, TIER, max_new=5,
                               faults=[{"kind": "spill", "count": -1}])
    np.testing.assert_array_equal(hs[0].result(1), pair.ref(TIER_PROMPT, 5))
    assert got["status"] == ["finished", "finished"]
    assert got["counters"]["serving/kv_host_errors"] > 0
    assert got["counters"].get("serving/request_retries", 0) == 0
    assert serving.engine._kv_host_pool.num_blocks == 0          # nothing demoted


def test_fetch_fault_contains_per_request_with_site_label(pair):
    """A fetch (H2D) step fault contains per request, labelled by its own
    dispatch site and not the enclosing prefill action, and the retry
    re-hits the surviving host entries for an identical completion."""
    trace = [("add", TIER_PROMPT), ("drive",), ("add", TIER_SCRATCH, {"max_new_tokens": 4}),
             ("drive",), ("add", TIER_PROMPT), ("drive",)]
    _, hs, got, _ = both(pair, trace, TIER, max_new=5,
                         faults=[{"kind": "fetch", "count": 1}])
    np.testing.assert_array_equal(hs[2].result(1), hs[0].result(1))
    c = got["counters"]
    assert c['serving/step_faults{kind="fetch"}'] == 1 and c["serving/request_retries"] == 1
    assert c["serving/kv_fetch_hits"] > 0                       # the retry fetched


def test_restart_with_prefix_cache_and_host_tier(pair):
    """Recovery under the whole cache stack: an engine-fatal decode fault
    after a warm half; the device prefix cache restarts cold, the host tier
    survives the rebuild (the rebuilt allocator holds the same pool), and
    the tokens hold."""
    ps = prompts((10, 9))
    warm = [("add", p) for p in ps] + [("drive",)]
    _, _, first, _ = both(pair, warm, TIER, max_new=6)
    n = len(first["actions"])
    serving, hs, got, _ = both(pair, warm + warm[:-1] + [("drive",)], TIER, max_new=6,
                               faults=_faults(("decode", n + 1, 1, "post")))
    assert got["restarts"] == 1
    assert serving._session.sched.allocator.host_pool is serving.engine._kv_host_pool
    for h, p in zip(hs[2:], ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 6))


def test_requeue_backoff_is_exponential_in_logical_steps(pair):
    _, hs, got, _ = both(pair, [("add", prompts((5,))[0]), ("drive",)],
                         {"fault": {"max_request_retries": 3, "retry_backoff_steps": 2}},
                         max_new=4, faults=_faults(("prefill", None, 2, "pre")))
    assert got["status"] == ["finished"]
    req = [e for e in pair.port._events.snapshot() if e.kind == "req.requeue"]
    assert [e.data["backoff_steps"] for e in req] == [2, 4]
    assert [e.data["retry"] for e in req] == [1, 2]


def test_quarantine_after_exactly_max_retries(pair):
    """A persistent per-request fault retries exactly max_request_retries
    times, then the request retires with its error while the loop serves
    the next one."""
    ps = prompts((5, 7))

    def then(serving, hs):
        fi.clear()
        jax_fi.clear()
        hs.append(serving.add_request(ps[1]))
        drive(serving)

    _, hs, got, _ = both(pair, [("add", ps[0]), ("drive",), ("call", then)],
                         {"fault": {"max_request_retries": 2, "retry_backoff_steps": 1}},
                         max_new=6, faults=_faults(("prefill", None, 3, "pre")))
    assert got["status"] == ["error", "finished"] and "quarantined after 2" in hs[0].error
    with pytest.raises(serve.RequestFailed, match="quarantined"):
        hs[0].result(1)
    np.testing.assert_array_equal(hs[1].result(1), pair.ref(ps[1], 6))
    assert got["counters"]["serving/request_retries"] == 2
    assert {k: v for k, v in got["counters"].items() if k.startswith("serving/step_faults")} \
        == {'serving/step_faults{kind="prefill"}': 3}
    assert not got["crash_loop"]


def test_progress_resets_retry_count(pair):
    prompt = prompts((5,))[0]
    _, hs, got, _ = both(pair, [("add", prompt), ("drive",)],
                         {"fault": {"max_request_retries": 2, "retry_backoff_steps": 1}},
                         max_new=16, faults=_faults(*[("decode", at, 1, "pre")
                                                      for at in (3, 9, 15, 21)]))
    assert got["status"] == ["finished"]
    np.testing.assert_array_equal(hs[0].result(1), pair.ref(prompt, 16))


class _Broken(SchedulingPolicy):
    def select_admission(self, sched):
        return 99                        # out of range: a ValueError every step


def test_unattributed_fault_escalates_instead_of_livelocking(pair):
    """A fault before any action is chosen escalates through the restart
    path into the breaker (bounded), never a hot spin; the JAX loop does the
    same with its own policy class."""
    from deepspeed_tpu.inference.policy import SchedulingPolicy as JaxPolicy

    class JaxBroken(JaxPolicy):
        def select_admission(self, sched):
            return 99

    outs = []
    for side, policy in (("jax", JaxBroken()), ("port", _Broken())):
        fresh(pair, fault={"max_request_retries": 1, "max_engine_restarts": 1})
        eng, mod = pair.side[side][:2]
        serving = mod.AsyncServingEngine(eng, max_new_tokens=4, start=False, policy=policy)
        h = serving.add_request(prompts((5,))[0])
        drive(serving, limit=200)
        outs.append((serving._crash_loop, serving.restarts, h.status))
        serving.shutdown(drain=True)
    assert outs[0] == outs[1] == (True, 1, "error")


def test_transient_unattributed_faults_do_not_accumulate(pair):
    from deepspeed_tpu.inference.policy import SchedulingPolicy as JaxPolicy

    def flaky(base):
        class Flaky(base):
            calls = 0

            def select_admission(self, sched):
                Flaky.calls += 1
                if Flaky.calls in (1, 3):        # two separated glitches
                    raise RuntimeError("transient scheduler glitch")
                return 0
        return Flaky()

    outs = []
    for side, policy in (("jax", flaky(JaxPolicy)), ("port", flaky(SchedulingPolicy))):
        fresh(pair, max_running=1, fault={"max_request_retries": 1, "max_engine_restarts": 1})
        eng, mod = pair.side[side][:2]
        serving = mod.AsyncServingEngine(eng, max_new_tokens=4, start=False, policy=policy)
        hs = [serving.add_request(p) for p in prompts((5, 7))]
        drive(serving)
        serving.shutdown(drain=True)
        outs.append((serving.restarts, serving._crash_loop, [h.generated for h in hs],
                     [h.status for h in hs]))
    assert outs[0] == outs[1]
    assert outs[1][:2] == (0, False) and outs[1][3] == ["finished", "finished"]


def test_fused_fault_requeues_all_rows_identically(pair):
    ps = prompts((5, 11))
    _, hs, got, _ = both(pair, [("add", p) for p in ps] + [("drive",)],
                         faults=_faults(("decode", 6, 1, "pre")))
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 8))
    assert got["counters"]["serving/request_retries"] == 2
    admits = [rid for k, rid in got["events"] if k == "req.admit"]
    assert admits == [hs[0].rid, hs[1].rid, hs[0].rid, hs[1].rid]


# --------------------------------------------------------------------- #
# engine-fatal faults: recovery and the breaker


def test_restart_token_identity_one_restart_event(pair):
    """A post-dispatch fault (the pools half-written) at a pinned step:
    every request completes identically, with exactly one restart, and the
    loop still serves afterwards."""
    ps = prompts((5, 11, 3))

    def after(serving, hs):
        fi.clear()
        jax_fi.clear()
        hs.append(serving.add_request(ps[0]))
        drive(serving)

    _, hs, got, _ = both(pair, [("add", p) for p in ps] + [("drive",), ("call", after)],
                         faults=_faults(("decode", 7, 1, "post")))
    assert got["restarts"] == 1 and not got["crash_loop"]
    assert got["status"] == ["finished"] * 4
    for h, p in zip(hs, ps + [ps[0]]):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 8))
    kinds = [k for k, _ in got["events"]]
    assert kinds.count("serve.restart") == 1 and kinds.count("serve.fault") == 1


def test_restart_sequence_is_replay_deterministic(pair):
    trace = [("add", p) for p in prompts((5, 11))] + [("drive",)]
    faults = _faults(("decode", 6, 1, "post"), ("prefill", 2, 1, "pre"))
    lifecycle = ("req.admit", "req.requeue", "serve.fault", "serve.restart", "req.retire")
    runs = []
    for _ in range(2):
        _, _, got, _ = both(pair, trace, faults=faults)
        runs.append(([e for e in got["events"] if e[0] in lifecycle], got["tokens"]))
    assert runs[0] == runs[1] and ("serve.restart", None) in runs[0][0]


def _health(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_breaker_flips_healthz_503_and_drain_still_works(pair):
    box = {}

    def serve_http(serving, hs):
        if isinstance(serving, serve.AsyncServingEngine):
            box["server"] = serve.build_http_server(serving, port=0)
            box["thread"] = threading.Thread(target=box["server"].serve_forever, daemon=True)
            box["thread"].start()
            assert _health(box["server"].server_address[1])[0] == 200

    try:
        serving, hs, got, _ = both(
            pair, [("call", serve_http)] + [("add", p) for p in prompts((5, 11))] + [("drive",)],
            {"fault": {"max_engine_restarts": 1}}, shutdown=False,
            faults=_faults(("decode", None, -1, "post")))
        assert got["crash_loop"] and got["restarts"] == 1
        assert got["status"] == ["error", "error"]
        with pytest.raises(serve.RequestFailed, match="crash-loop"):
            hs[0].result(1)
        port = box["server"].server_address[1]
        status, body = _health(port)
        assert status == 503 and body["state"] == "crash_loop" and body["restarts"] == 1
        with pytest.raises(RuntimeError, match="crash-loop"):
            serving.add_request(prompts((5,))[0])
        serving.shutdown(drain=True)
        status, body = _health(port)
        assert status == 503 and body["state"] == "stopped"
    finally:
        box["server"].shutdown()
        box["thread"].join(60)


def test_breaker_counts_restarts_in_telemetry(pair):
    _, _, got, _ = both(pair, [("add", prompts((5,))[0]), ("drive",)],
                        {"fault": {"max_engine_restarts": 2}}, max_new=6,
                        faults=_faults(("decode", None, -1, "post")))
    assert got["counters"]["serving/engine_restarts"] == 2 and got["crash_loop"]


def test_closed_loop_still_raises(pair):
    fresh(pair)
    with fi.inject(fi.FaultInjector().fail_step("decode", count=1)):
        with pytest.raises(RuntimeError, match="injected"):
            pair.port.generate_batch(prompts((5,)), max_new_tokens=8)


# --------------------------------------------------------------------- #
# deadlines


def test_logical_step_deadline_times_out(pair):
    _, hs, got, _ = both(pair, [("add", prompts((5,))[0], {"deadline_steps": 3}),
                                ("add", prompts((11,))[0]), ("drive",)], {"max_running": 1})
    assert got["status"] == ["timeout", "finished"] and "scheduler steps" in hs[0].error
    with pytest.raises(serve.RequestFailed, match="timeout"):
        hs[0].result(1)


def test_wall_clock_deadline_at_intake(pair, tmp_path):
    def late(serving, hs):
        time.sleep(0.01)                 # late before the loop picks it up
        drive(serving)

    _, hs, got, _ = both(pair, [("add", prompts((5,))[0], {"deadline_ms": 0.001}),
                                ("call", late)], max_new=4)
    assert got["status"] == ["timeout"] and "before the request" in hs[0].error
    assert got["counters"]["serving/timeouts"] == 1
    evs = [e for e in pair.port._events.snapshot() if e.kind == "req.timeout"]
    assert len(evs) == 1 and evs[0].rid is None
    path = pair.port.export_serving_trace(str(tmp_path / "intake_timeout_trace.json"))
    assert cli.load_validator().validate_path(path, kind="chrome") == []


def test_timeout_keeps_partial_tokens_and_emits_event(pair):
    _, hs, got, _ = both(pair, [("add", prompts((5,))[0], {"deadline_steps": 8}), ("drive",)],
                         max_new=30)
    assert got["status"] == ["timeout"] and 0 < len(hs[0].generated) < 30
    evs = [e for e in pair.port._events.snapshot() if e.kind == "req.timeout"]
    assert len(evs) == 1 and evs[0].rid == hs[0].rid
    assert evs[0].data["generated"] == len(hs[0].generated)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn.getresponse()


def test_http_504_and_sse_finish_reason(pair):
    fresh(pair, max_running=1)
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=8)
    server = serve.build_http_server(serving, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        r = _post(port, {"prompt": [1, 2, 3], "max_tokens": 4, "deadline_ms": 0.001})
        assert r.status == 504 and "deadline" in json.loads(r.read())["error"]
        r = _post(port, {"prompt": [1, 2, 3], "max_tokens": 4})
        assert r.status == 200
        body = json.loads(r.read())
        np.testing.assert_array_equal(body["choices"][0]["token_ids"],
                                      pair.ref(np.array([1, 2, 3]), 4)[3:])
    finally:
        server.shutdown()
        t.join(60)
        serving.shutdown(drain=True, timeout=120)


def test_sse_stream_finish_reason_timeout(pair):
    _, hs, got, _ = both(pair, [("add", prompts((5,))[0], {"deadline_steps": 8}), ("drive",)],
                         max_new=30)
    assert {"finished": "stop"}.get(hs[0].status, hs[0].status) == "timeout"
    assert [t for b in hs[0].stream(timeout=0) for t in b] == hs[0].generated


# --------------------------------------------------------------------- #
# load shedding


def test_sheds_lowest_priority_first_deterministically(pair):
    trace = [("add", p, {"priority": pr}) for p, pr in zip(prompts((5, 6, 7, 8, 9)),
                                                           (5, 0, 0, 3, 1))] + [("drive",)]
    _, hs, got, _ = both(pair, trace, {"max_running": 1, "fault": {"shed_queue_depth": 2}},
                         max_new=4)
    assert got["status"] == ["finished", "rejected", "rejected", "finished", "rejected"]
    shed = [h for h in hs if h.status == "rejected"]
    assert all("shed" in h.error and h.retry_after >= 1.0 for h in shed)
    assert got["counters"]["serving/shed_requests"] == 3


def test_shed_event_closes_span_in_trace(pair, tmp_path):
    _, hs, got, _ = both(pair, [("add", p) for p in prompts((5, 6, 7))] + [("drive",)],
                         {"max_running": 1, "fault": {"shed_queue_depth": 1}}, max_new=4)
    shed = {h.rid for h in hs if h.status == "rejected"}
    assert shed and {rid for k, rid in got["events"] if k == "req.shed"} == shed
    path = pair.port.export_serving_trace(str(tmp_path / "shed_trace.json"))
    assert cli.load_validator().validate_path(path, kind="chrome") == []


def test_admission_control_rejection_carries_retry_after(pair):
    _, hs, _, _ = both(pair, [("add", p) for p in prompts((5, 5, 5, 5))] + [("drive",)],
                       max_new=4, policy={"name": "fifo", "admission_max_queue": 1})
    rejected = [h for h in hs if h.status == "rejected"]
    assert rejected and all(1.0 <= h.retry_after <= 120 for h in rejected)


def test_http_429_with_retry_after_header(pair):
    fresh(pair)
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=16,
                                       policy={"name": "fifo", "admission_max_queue": 1})
    server = serve.build_http_server(serving, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port, results = server.server_address[1], []

        def post():
            r = _post(port, {"prompt": [1, 2, 3, 4, 5], "max_tokens": 16})
            results.append((r.status, r.getheader("Retry-After"), r.read()))

        threads = [threading.Thread(target=post) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        serving.shutdown(drain=True, timeout=120)
        codes = [c for c, _, _ in results]
        assert 429 in codes, codes
        for code, ra, body in results:
            if code == 429:
                assert int(ra) >= 1 and "admission control" in json.loads(body)["error"]
    finally:
        server.shutdown()
        t.join(60)


# --------------------------------------------------------------------- #
# scheduler retry units


def test_requeue_sets_holddown_and_wait_action_ticks():
    s = ContinuousBatchingScheduler(BlockAllocator(9, 8), 2, 8)
    r = s.add_request([1] * 4, max_new=4)
    s.next_action()
    s.record_prefill(r, 9)
    s.requeue_for_retry(r, backoff_steps=3, error="boom")
    assert r.state == "queued" and not r.blocks and r.retry_at_step == s.step_seq + 3
    kinds = []
    for _ in range(10):
        kinds.append(s.next_action()[0])
        if kinds[-1] != "wait":
            break
    assert kinds[:3] == ["wait"] * 3 and kinds[3] in ("prefill", "prefill_chunk")


def test_backoff_does_not_starve_other_admissions():
    s = ContinuousBatchingScheduler(BlockAllocator(9, 8), 2, 8)
    r0 = s.add_request([1] * 4, max_new=4)
    s.next_action()
    s.record_prefill(r0, 9)
    s.requeue_for_retry(r0, backoff_steps=50, error="boom")
    r1 = s.add_request([2] * 4, max_new=2)
    assert s.next_action()[1] is r1


# --------------------------------------------------------------------- #
# observability


def test_fault_events_validate_and_render(pair, tmp_path):
    trace = [("add", p) for p in prompts((5, 11))] + [
        ("add", prompts((7,))[0], {"deadline_steps": 2}), ("drive",)]
    _, hs, got, _ = both(pair, trace, {"fault": {"max_request_retries": 1,
                                                 "retry_backoff_steps": 1}}, max_new=6,
                         faults=_faults(("prefill", 1, 1, "pre"), ("decode", 6, 1, "post")))
    kinds = {k for k, _ in got["events"]}
    assert {"serve.fault", "serve.restart", "req.requeue", "req.timeout"} <= kinds
    validator = cli.load_validator()
    jp = str(tmp_path / "events.jsonl")
    pair.port._events.write_jsonl(jp)
    assert validator.validate_path(jp, kind="events") == []
    tp = pair.port.export_serving_trace(str(tmp_path / "trace.json"))
    assert validator.validate_path(tp, kind="chrome") == []
    doc = json.load(open(tp))
    names = [e["name"] for e in doc["traceEvents"]]
    assert "fault" in names and "restart" in names
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "request"
             and e.get("tid") == hs[2].rid]
    if spans:
        assert spans[0]["args"].get("timed_out")
    assert hs[0].status == hs[1].status == "finished"


def test_health_pane_fault_rows(pair):
    from deepspeed_tpu_torch.monitor.health import health_summary, render_summary_table
    trace = [("add", p, {"priority": i}) for i, p in enumerate(prompts((5, 6, 7, 8)))] + [
        ("add", prompts((9,))[0], {"priority": 9, "deadline_steps": 1}), ("drive",)]
    both(pair, trace, {"max_running": 1, "fault": {"max_request_retries": 3,
                                                   "retry_backoff_steps": 1,
                                                   "shed_queue_depth": 2}},
         max_new=4, faults=_faults(("decode", None, 1, "pre"), ("decode", None, 1, "post")))
    s = health_summary(pair.port.telemetry_snapshot())
    srv = s["serving"]
    assert sum(srv["step_faults"].values()) == 2 and srv["engine_restarts"] == 1
    assert srv["request_retries"] >= 1 and srv["timeouts"] == 1 and srv["shed_requests"] >= 1
    table = render_summary_table(s)
    assert "faults 2" in table and "restart 1" in table
    assert "timeout 1" in table and "shed" in table


# --------------------------------------------------------------------- #
# serve: the graceful SIGTERM / SIGINT drain


def test_sigterm_drains_and_exits_128_plus_signum(pair):
    """The handler stops intake, unblocks serve_forever, the in-flight
    request is served out, and ``serve_main`` returns 128 + SIGTERM;
    a second signal is ignored."""
    holder, ready, rc = {}, threading.Event(), {}

    def cb(server, serving):
        holder.update(server=server, serving=serving)
        ready.set()

    argv = ["--port", "0", "--dtype", "fp32", "--device", "cpu", "--max-new", "6",
            "--block-size", "8", "--max-running", "2", "--grace", "60"]
    t = threading.Thread(target=lambda: rc.update(rc=serve.serve_main(
        argv, model=pair.pmodel, params=pair.pparams, ready_cb=cb)), daemon=True)
    t.start()
    assert ready.wait(120), "serve never bound its socket"
    serving = holder["serving"]
    prompt = np.arange(1, 6, dtype=np.int32)
    h = serving.add_request(prompt)
    assert next(h.stream(timeout=120))        # mid-decode: the drain serves it out
    handler = serving._signal_handler
    handler.trigger(signal.SIGTERM)
    t.join(120)
    assert not t.is_alive() and rc["rc"] == 128 + signal.SIGTERM
    assert h.status == "finished" and len(h.generated) == 6
    np.testing.assert_array_equal(h.result(1), pair.ref(prompt, 6))
    handler.trigger(signal.SIGINT)
    assert handler.signum == signal.SIGTERM
    with pytest.raises(RuntimeError):
        serving.add_request(np.arange(1, 4, dtype=np.int32))


def test_handler_install_restores_previous():
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal installation needs the main thread")
    prev = signal.getsignal(signal.SIGTERM)

    class _Srv:
        def shutdown(self):
            pass

    class _Serving:
        def drain(self):
            pass

    handler = serve.ServeSignalHandler(_Srv(), _Serving()).install()
    assert signal.getsignal(signal.SIGTERM) == handler._handle
    handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


# --------------------------------------------------------------------- #
# the adaptive controller wired to the loop (apply_fn = apply_knobs)


def _controller(serving):
    """The package's AdaptiveController over the loop's knobs, its apply_fn
    the loop's knob intake (as ``serve --adaptive`` wires it), with a TTFT
    burn of 2 planted in the package's registry."""
    if isinstance(serving, serve.AsyncServingEngine):
        from deepspeed_tpu_torch.monitor.controller import AdaptiveController, knobs_from_serving
        from deepspeed_tpu_torch.monitor.metrics import get_registry
    else:
        from deepspeed_tpu.monitor.controller import AdaptiveController, knobs_from_serving
        from deepspeed_tpu.monitor.metrics import get_registry
    g = get_registry().gauge("slo/burn_rate", "error-budget burn",
                             labelnames=("objective", "window"))
    for w in ("8", "2"):
        g.labels(objective="ttft_p99", window=w).set(2.0)
    eng = serving.engine
    return AdaptiveController(knobs_from_serving(eng.config.serving, policy=serving.policy),
                              events=eng._events, apply_fn=serving.apply_knobs,
                              cooldown_ticks=1, relax_after=2)


def test_controller_posture_applies_between_steps_and_survives_restart(pair):
    """A controller tick queues its actions; the loop applies them at the
    next step (``ctl.apply``, the posture on /healthz) and re-applies them
    from its ledger after an engine restart (``restart=True``); tokens stay
    the closed loop's, in both packages."""
    ps = prompts((5, 9))
    seen = {}

    def tick(serving, hs):
        actions = _controller(serving).tick()
        assert any(a.knob == "max_queue" for a in actions)
        assert serving.policy.admission_max_queue == 6      # queued, not yet applied

    def applied(serving, hs):
        seen[type(serving).__module__] = (serving.policy.admission_max_queue,
                                          serving.health_state()[1]["ctl_knobs"])

    trace = [("call", tick), ("step", 1), ("call", applied)] + [("add", p) for p in ps] + [
        ("drive",), ("call", applied)]
    serving, hs, got, _ = both(pair, trace, {"policy": {"name": "fifo",
                                                        "admission_max_queue": 6}},
                               faults=_faults(("decode", 7, 1, "post")))
    assert got["restarts"] == 1 and got["status"] == ["finished", "finished"]
    assert seen[serve.__name__] == (3, {"max_queue": 3})
    restart_applies = [e.data["knob"] for e in pair.port._events.snapshot()
                       if e.kind == "ctl.apply" and e.data.get("restart")]
    assert restart_applies == ["max_queue"]
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 8))


def test_prefill_chunk_knob_sizes_the_next_prefill(pair):
    """``apply_knobs`` of prefill_chunk lands in both homes (the scheduler
    decides to chunk, the session sizes the chunk): the next request's
    prefill runs in chunks of the new size, tokens unchanged."""
    p = prompts((11,))[0]

    def knob(serving, hs):
        serving.apply_knobs([{"knob": "prefill_chunk", "value": 4, "prev": 0,
                              "direction": "tighten", "tick": 1, "reason": "test"}])

    _, hs, got, _ = both(pair, [("call", knob), ("step", 1), ("add", p), ("drive",)])
    chunks = [e for e in pair.port._events.snapshot() if e.kind == "req.prefill_chunk"]
    assert [e.data["tokens"] for e in chunks] == [4, 4, 3]
    np.testing.assert_array_equal(hs[0].result(1), pair.ref(p, 8))


def test_restart_frees_the_faulted_pools_before_building_new_ones(pair):
    """An engine-fatal fault's traceback would keep the half-written pools
    alive through the restart, so that the card held two pools while it
    rebuilt; the loop drops it, and the old pools are gone by the time the
    new ones are allocated."""
    import weakref

    fresh(pair)
    eng = pair.port
    serving = serve.AsyncServingEngine(eng, max_new_tokens=4, start=False)
    old = weakref.ref(serving._session.pools["k"])
    alive_at_rebuild = []
    real = eng._paged_pools

    def paged_pools(*a, **k):
        alive_at_rebuild.append(old() is not None)
        return real(*a, **k)

    eng._paged_pools = paged_pools
    try:
        with fi.inject(fi.FaultInjector().fail_step("decode", count=1, phase="post")):
            h = serving.add_request(prompts((6,))[0])
            drive(serving)
    finally:
        del eng._paged_pools
    serving.shutdown(drain=True)
    assert serving.restarts == 1 and alive_at_rebuild == [False]
    np.testing.assert_array_equal(h.result(1), pair.ref(prompts((6,))[0], 4))
