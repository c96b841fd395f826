"""The port's async serving front-end (``deepspeed_tpu_torch/inference/serve.py``)
against the JAX package's: the counterparts of ``tests/unit/test_serving_async.py``
(scheduler cancellation, the loop driven synchronously, the serving thread,
the flight-recorder edges and serving telemetry, ``serve`` over HTTP).

The same seeded trace (submissions, steps, cancellations, drains) goes
through the JAX ``AsyncServingEngine(start=False)`` and the port's, on a
tiny Llama (2 layers, d 64, fp32, greedy) with the same weights: per
request the tokens, the statuses, the scheduler's action sequence (limit 0)
the order of the flight-recorder events and the serving counters agree.
One JAX and one port
engine serve the whole module: :func:`fresh` sets each test's serving
config and clears what a new engine would not hold (the pools, the prefix
cache, the rid counter, the recorder and the registry). The threaded and
HTTP tests hold the port to the JAX engine's closed-loop tokens."""

import contextlib
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference import serve as jax_serve
from deepspeed_tpu.inference.block_allocator import BlockAllocator as JaxAllocator
from deepspeed_tpu.inference.scheduler import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.monitor.events import get_flight_recorder as jax_recorder
from deepspeed_tpu.monitor.metrics import get_registry as jax_registry
from deepspeed_tpu.utils import fault_injection as jax_fi

import deepspeed_tpu_torch
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference import serve
from deepspeed_tpu_torch.inference.block_allocator import BlockAllocator
from deepspeed_tpu_torch.inference.scheduler import FINISHED, ContinuousBatchingScheduler
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor.events import get_flight_recorder
from deepspeed_tpu_torch.monitor.metrics import get_registry
from deepspeed_tpu_torch.utils import fault_injection as fi

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LLAMA = dict(vocab_size=64, max_seq=64, n_layer=2, n_head=2, n_kv_head=1, d_model=64,
             d_ff=128, pos_embedding="rope", norm="rmsnorm", activation="swiglu",
             tie_embeddings=False, norm_eps=1e-6)
BASE = {"block_size": 8, "max_running": 2}


class Pair:
    """One JAX and one port serving engine over the same weights (telemetry
    and events on), and the per-package modules a trace runs through."""

    def __init__(self):
        self.jmodel = JaxCausalLM(JT.TransformerConfig(remat=False, **LLAMA))
        self.jparams = jax.tree.map(np.asarray, JT.init_params(self.jmodel.config,
                                                               jax.random.key(7)))
        self.pmodel = CausalLM(TransformerConfig(**LLAMA))
        self.pparams = params_from_jax(self.pmodel.config, self.jparams)
        tel = {"enabled": True, "events": True}
        self.jax = deepspeed_tpu.init_inference(self.jmodel, params=self.jparams,
                                                dtype="fp32", serving=BASE, telemetry=tel)
        self.port = deepspeed_tpu_torch.init_inference(self.pmodel, params=self.pparams,
                                                       dtype="fp32", device="cpu",
                                                       serving=BASE, telemetry=tel)
        self.side = {"jax": (self.jax, jax_serve, jax_fi, jax_recorder, jax_registry),
                     "port": (self.port, serve, fi, get_flight_recorder, get_registry)}
        self._refs = {}

    def ref(self, prompt, max_new, eos=None):
        """The JAX engine's closed-loop greedy tokens for one prompt."""
        key = (tuple(int(t) for t in prompt), max_new, eos)
        if key not in self._refs:
            self._refs[key] = np.asarray(self.jax.generate(
                np.asarray(prompt)[None, :], max_new_tokens=max_new, eos_token_id=eos))[0]
        return self._refs[key]


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    for rec in (jax_recorder(), get_flight_recorder()):
        rec.clear()
    jax_registry().reset()
    get_registry().reset()


def fresh(pair, **serving):
    """Both engines as newly built with ``serving`` over the base config:
    the serving section set, the pools, the prefix cache, the host KV tier
    and the rid counter dropped, the recorders and registries cleared."""
    for name, (eng, *_, rec, reg) in pair.side.items():
        cfg = {**BASE, **serving}
        eng._config.serving = type(eng._config.serving)(**cfg)
        eng._paged_workspace = None
        eng._paged_alloc = None
        eng._kv_host_pool = None
        eng._serve_rid_base = 0
        rec().clear()
        reg().reset()
        reg().set_enabled(True)


def prompts(lens=(5, 11, 3, 8), vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def record_actions(serving):
    """Log the scheduler's actions as (kind, rids)."""
    sched, log = serving._session.sched, []
    real = sched.next_action

    def logged():
        a = real()
        if a is not None:
            kind, payload = a
            items = payload if isinstance(payload, list) else [payload]
            log.append((kind, tuple(r.rid for r in items if hasattr(r, "rid"))))
        return a

    sched.next_action = logged
    return log


def drive(serving, limit=2000):
    n = 0
    while serving.step():
        n += 1
        assert n < limit, "serving loop did not converge"


def run(pair, side, trace, *, max_new=8, policy=None, faults=(), shutdown=True):
    """One package's run of ``trace``: ops ``("add", prompt, kwargs)``,
    ``("step", n)``, ``("cancel", i)``, ``("drain",)``, ``("drive",)``,
    ``("call", fn)`` (``fn(serving, handles)``), under an injector built from
    ``faults`` (``fail_step`` keyword dicts). Returns the loop, its handles and
    what is compared: statuses, tokens, errors, actions and event order."""
    eng, mod, fim, rec, reg = pair.side[side]
    serving = mod.AsyncServingEngine(eng, max_new_tokens=max_new, start=False, policy=policy)
    actions = record_actions(serving)
    hs = []
    inj = fim.FaultInjector()
    for f in faults:
        inj.fail_step(**f)
    with fim.inject(inj) if faults else contextlib.nullcontext():
        for op, *args in trace:
            if op == "add":
                p, kw = (args + [{}])[:2]
                hs.append(serving.add_request(p, **kw))
            elif op == "step":
                for _ in range(args[0]):
                    serving.step()
            elif op == "cancel":
                hs[args[0]].cancel()
            elif op == "drain":
                serving.drain()
            elif op == "drive":
                drive(serving)
            else:
                args[0](serving, hs)
    if shutdown:
        serving.shutdown(drain=True)
    events = [(e.kind, e.rid) for e in rec().snapshot()]
    counters = {k: v for k, v in reg().snapshot()["counters"].items()
                if k.startswith("serving/")}
    out = {"status": [h.status for h in hs], "tokens": [h.generated for h in hs],
           "actions": actions, "events": events, "restarts": serving.restarts,
           "crash_loop": serving._crash_loop, "counters": counters}
    return serving, hs, out


def both(pair, trace, serving_cfg=None, **kw):
    """The trace through the JAX loop, then the port's, each on a fresh
    engine state; asserts they agree on everything :func:`run` compares and
    returns the port's (loop, handles, record) and the JAX record."""
    fresh(pair, **(serving_cfg or {}))
    jserving, _, want = run(pair, "jax", trace, **kw)
    jserving.shutdown(drain=True)            # a no-op when the trace stopped it
    fresh(pair, **(serving_cfg or {}))
    serving, hs, got = run(pair, "port", trace, **kw)
    for key in ("status", "tokens", "actions", "restarts", "crash_loop", "counters"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert [k for k, _ in got["events"]] == [k for k, _ in want["events"]]
    assert got["events"] == want["events"]
    return serving, hs, got, want


# --------------------------------------------------------------------- #
# scheduler cancellation (both schedulers, the same calls)


@pytest.mark.parametrize("case", ["queued", "finished_is_noop", "mid_batch"])
def test_scheduler_cancel(case):
    """TestSchedulerCancel: cancel a queued request, a finished one (no-op)
    and one row of a running batch; both schedulers end in the same state."""
    outs = []
    for sched_cls, alloc_cls in ((JaxScheduler, JaxAllocator),
                                 (ContinuousBatchingScheduler, BlockAllocator)):
        if case == "queued":
            s = sched_cls(alloc_cls(9, 8), 1, 8)
            r0 = s.add_request([1] * 4, max_new=4)
            r1 = s.add_request([2] * 4, max_new=4)
            assert s.cancel_request(r1)
            assert r1.state == FINISHED and r1.cancelled and not r1.blocks
            assert list(s.waiting) == [r0] and r1 in s.finished
            s.next_action()
            s.record_prefill(r0, 9)
            assert s.cancel_request(r0)
            assert s.allocator.num_used == 0 and s.all_done()
            outs.append([(r.rid, r.state, r.cancelled) for r in s.finished])
        elif case == "finished_is_noop":
            s = sched_cls(alloc_cls(9, 8), 1, 8)
            r = s.add_request([1] * 4, max_new=1)
            s.next_action()
            s.record_prefill(r, 9)
            assert r.state == FINISHED and not s.cancel_request(r) and not r.cancelled
            outs.append((r.state, r.generated))
        else:
            s = sched_cls(alloc_cls(9, 8), 2, 8)
            r0 = s.add_request([1] * 4, max_new=8)
            r1 = s.add_request([2] * 4, max_new=8)
            for r in (r0, r1):
                s.next_action()
                s.record_prefill(r, 5)
            s.cancel_request(r0)
            kind, batch = s.next_action()
            assert kind == "decode" and batch == [r1]
            outs.append((kind, [r.rid for r in batch], s.allocator.num_used))
    assert outs[0] == outs[1]


# --------------------------------------------------------------------- #
# the loop driven synchronously (start=False)


def test_interleaved_arrivals_greedy_identity(pair):
    """Requests added while others decode, mixed priorities, one cancelled
    while queued: every finished request equals its own closed-loop serve,
    and each handle's streamed bursts concatenate to its tokens."""
    ps = prompts((5, 11, 3, 8))
    trace = [("add", ps[0]), ("add", ps[1]), ("step", 5), ("add", ps[2], {"priority": 5}),
             ("add", ps[3], {"priority": 1}), ("step", 3), ("cancel", 3), ("drive",)]
    _, hs, got, _ = both(pair, trace, {"policy": "priority"})
    assert got["status"] == ["finished"] * 3 + ["cancelled"]
    for h, p in zip(hs[:3], ps):
        np.testing.assert_array_equal(h.result(1), pair.ref(p, 8))
        assert [t for b in h.stream(timeout=0) for t in b] == h.generated


def test_streaming_carries_spec_bursts(pair):
    rng = np.random.default_rng(1)
    prompt = np.tile(rng.integers(0, 8, size=8).astype(np.int32), 3)
    _, hs, got, _ = both(pair, [("add", prompt), ("drive",)],
                         {"speculative": {"mode": "ngram", "k": 4}}, max_new=16)
    bursts = list(hs[0].stream(timeout=0))
    assert any(len(b) > 1 for b in bursts), "no multi-token burst despite speculation on"
    np.testing.assert_array_equal(hs[0].result(1), pair.ref(prompt, 16))
    assert [t for b in bursts for t in b] == hs[0].generated
    assert pair.port._last_serve_stats["spec_accepted"] > 0


def test_trace_replay_is_deterministic_and_cross_policy(pair):
    """The pinned trace replays identically (admissions, preemptions,
    retirements, the cancellation; tokens) and agrees across policies on a
    trace with no priorities or budgets, in both packages."""
    ps = prompts((5, 11, 7))
    trace = [("add", ps[0]), ("add", ps[1]), ("step", 4), ("add", ps[2]), ("step", 2),
             ("cancel", 0), ("drive",)]
    lifecycle = ("req.submit", "req.admit", "req.preempt", "req.retire", "req.cancel",
                 "serve.drain")
    runs = []
    for policy in ("fifo", "fifo", "sla"):
        _, _, got, _ = both(pair, trace, {"max_num_blocks": 5, "policy": policy}, max_new=10)
        runs.append(([e for e in got["events"] if e[0] in lifecycle], got["tokens"]))
    assert runs[0] == runs[1] == runs[2]
    assert any(k == "req.preempt" for k, _ in runs[0][0])
    assert any(k == "req.cancel" for k, _ in runs[0][0])


def test_admission_control_rejects_under_pressure(pair):
    trace = [("add", p) for p in prompts((5, 5, 5, 5, 5))] + [("step", 1)]
    rejected = []

    def check(serving, hs):
        rejected.extend(h for h in hs if h.status == "rejected")
        drive(serving)

    _, hs, got, _ = both(pair, trace + [("call", check)], max_new=4,
                         policy={"name": "fifo", "admission_max_queue": 1})
    assert rejected
    with pytest.raises(serve.RequestFailed, match="admission control"):
        rejected[-1].result(1)
    assert all(h.status == "finished" for h in hs if h not in rejected)


def test_oversized_prompt_rejects_handle_not_loop(pair):
    p = prompts((5,))[0]
    trace = [("add", np.ones(80, np.int32)), ("add", p, {"max_new_tokens": 0}), ("add", p),
             ("drive",)]
    _, hs, got, _ = both(pair, trace, max_new=4)
    assert got["status"] == ["rejected", "rejected", "finished"]
    assert "max_seq" in hs[0].error and ">= 1" in hs[1].error


def test_generate_batch_guarded_while_loop_active(pair):
    fresh(pair)
    for eng, mod in ((pair.jax, jax_serve), (pair.port, serve)):
        serving = mod.AsyncServingEngine(eng, max_new_tokens=4, start=False)
        with pytest.raises(RuntimeError, match="active") as e:
            eng.generate_batch(prompts((4,)), max_new_tokens=2)
        msg = str(e.value)
        serving.shutdown(drain=True)
        eng.generate_batch(prompts((4,)), max_new_tokens=2)     # fine once it is closed
    jmsg = "another serving session is active on this engine (an AsyncServingEngine loop"
    assert msg.startswith(jmsg)


def test_shutdown_without_drain_cancels_in_flight(pair):
    def abort(serving, hs):
        serving.shutdown(drain=False)

    _, hs, got, _ = both(pair, [("add", p) for p in prompts((5, 11))]
                         + [("step", 3), ("call", abort)], shutdown=False)
    assert got["status"] == ["cancelled", "cancelled"] and all(h.done() for h in hs)
    pair.port.generate_batch(prompts((4,)), max_new_tokens=2)     # the engine is reusable


def test_pool_exhaustion_fails_request_not_loop(pair):
    """One request outgrowing an exhausted pool retires with an error; the
    loop survives and serves the next request."""
    after = {}

    def then(serving, hs):
        assert hs[0].status == "error" and serving.error is None
        with pytest.raises(serve.RequestFailed if isinstance(serving, serve.AsyncServingEngine)
                           else jax_serve.RequestFailed, match="max_num_blocks"):
            hs[0].result(1)
        after["ok"] = serving.add_request(np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
        drive(serving)

    _, hs, got, _ = both(pair, [("add", np.arange(1, 9, dtype=np.int32)), ("drive",),
                                ("call", then)], {"max_num_blocks": 3}, max_new=30)
    assert after["ok"].status == "finished" and len(after["ok"].generated) == 4


def test_open_loop_trims_finished_requests(pair):
    def check(serving, hs):
        assert all(h.status == "finished" for h in hs)
        assert serving._session.sched.finished == [] and serving._handles == {}

    both(pair, [("add", p) for p in prompts((5, 11, 3))] + [("drive",), ("call", check)],
         max_new=4)


def test_add_after_drain_raises(pair):
    fresh(pair)
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=4, start=False)
    serving.drain()
    with pytest.raises(RuntimeError, match="draining"):
        serving.add_request(prompts((5,))[0])
    serving.shutdown(drain=True)


def test_per_request_max_new_and_eos(pair):
    p = prompts((5,))[0]
    eos = int(pair.ref(p, 8)[5])                 # a token really emitted
    _, hs, got, _ = both(pair, [("add", p, {"max_new_tokens": 3}),
                                ("add", p, {"eos_token_id": eos}), ("drive",)])
    assert len(hs[0].generated) == 3
    assert hs[1].generated[0] == eos and len(hs[1].generated) == 1


# --------------------------------------------------------------------- #
# the serving thread


def test_threaded_end_to_end(pair):
    fresh(pair)
    ps = prompts((5, 11, 3))
    with serve.AsyncServingEngine(pair.port, max_new_tokens=8) as serving:
        hs = [serving.add_request(p) for p in ps]
        outs = [h.result(timeout=120) for h in hs]
    for o, p in zip(outs, ps):
        np.testing.assert_array_equal(o, pair.ref(p, 8))
    assert serving._stopped and serving.error is None


def test_threaded_cancel_mid_flight(pair):
    fresh(pair)
    p_long, p_short = prompts((6, 4))
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=40)
    h_long = serving.add_request(p_long)
    h_short = serving.add_request(p_short, max_new_tokens=8)
    for _ in h_short.stream(timeout=120):
        pass                          # the short one finished; the long one decodes
    h_long.cancel()
    serving.shutdown(drain=True, timeout=120)
    assert h_long.status == "cancelled" and 0 < len(h_long.generated) < 40
    np.testing.assert_array_equal(h_short.result(1), pair.ref(p_short, 8))


def test_idle_loop_accepts_late_arrivals(pair):
    fresh(pair)
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=4)
    serving.add_request(prompts((5,))[0]).result(timeout=120)
    time.sleep(0.2)                   # the loop goes idle (condition wait)
    h2 = serving.add_request(prompts((7,))[0])
    assert h2.result(timeout=120) is not None
    serving.shutdown(drain=True, timeout=120)
    assert h2.status == "finished"


# --------------------------------------------------------------------- #
# flight-recorder edges, the serving trace and telemetry


def _cancel_trace():
    return [("add", p) for p in prompts((5, 11, 3))] + [
        ("step", 4), ("cancel", 1), ("drain",), ("drive",)]


def test_lifecycle_events_emitted(pair):
    both(pair, _cancel_trace(), max_new=6)
    events = pair.port._events.snapshot()
    kinds = [e.kind for e in events]
    assert (kinds.count("req.submit"), kinds.count("req.cancel"), kinds.count("serve.drain"),
            kinds.count("serve.end")) == (3, 1, 1, 1)
    assert all(e.rid is not None and e.data["prompt_tokens"] > 0
               for e in events if e.kind == "req.submit")
    drain = next(e for e in events if e.kind == "serve.drain")
    assert set(drain.data) == {"waiting", "running", "pending", "replica"}
    rid_cancel = next(e.rid for e in events if e.kind == "req.cancel")
    assert rid_cancel not in {e.rid for e in events if e.kind == "req.retire"}


def test_serving_trace_validates_with_cancel_span(pair, tmp_path):
    both(pair, _cancel_trace(), max_new=6)
    path = pair.port.export_serving_trace(str(tmp_path / "async_trace.json"))
    assert cli.load_validator().validate_path(path, kind="chrome") == []
    doc = json.load(open(path))
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "request" and e["ph"] == "X"]
    assert len(spans) == 3
    cancelled = [s for s in spans if s["args"].get("cancelled")]
    assert len(cancelled) == 1 and not cancelled[0]["args"].get("incomplete")
    instants = [e["name"] for e in doc["traceEvents"] if e.get("ph") == "i"]
    assert {"submit", "cancel", "drain"} <= set(instants)


def test_events_jsonl_validates_new_kinds(pair, tmp_path):
    both(pair, _cancel_trace(), max_new=6)
    path = str(tmp_path / "events.jsonl")
    pair.port._events.write_jsonl(path)
    assert cli.load_validator().validate_path(path, kind="events") == []
    assert {"req.submit", "req.cancel", "serve.drain"} <= {
        json.loads(line)["kind"] for line in open(path)}


def test_queue_wait_and_rejected_telemetry(pair):
    from deepspeed_tpu_torch.monitor.health import health_summary, render_summary_table
    _, hs, _, _ = both(pair, [("add", p) for p in prompts((5,) * 6)] + [("drive",)], max_new=4,
                       policy={"name": "fifo", "admission_max_queue": 2})
    snap = pair.port.telemetry_snapshot()
    n_rejected = snap["counters"]["serving/rejected_requests"]
    assert n_rejected == sum(h.status == "rejected" for h in hs) > 0
    qw = snap["histograms"]["serving/queue_wait_ms"]
    assert qw["count"] == len(hs) - n_rejected
    s = health_summary(snap)
    assert s["serving"]["rejected_requests"] == n_rejected
    assert s["serving"]["queue_wait_ms"]["count"] == qw["count"]
    table = render_summary_table(s)
    assert "wait p50" in table and f"rejected {int(n_rejected)}" in table


def test_queue_wait_not_reobserved_on_preemption(pair):
    fresh(pair, max_num_blocks=5)
    pair.port.generate_batch(prompts((5, 11)), max_new_tokens=10)
    snap = pair.port.telemetry_snapshot()
    assert snap["counters"]["serving/preemptions"] > 0
    assert snap["histograms"]["serving/queue_wait_ms"]["count"] == 2


def test_serve_emits_only_catalogued_kinds():
    """Every event kind ``serve.py`` emits is in the catalogue ``trace
    --validate`` checks against."""
    import inspect
    import re
    from deepspeed_tpu_torch.monitor.events import EVENT_KINDS
    emitted = set(re.findall(r'emit\(\s*"([a-z_.]+)"', inspect.getsource(serve)))
    emitted |= {"ctl.revert"}                 # chosen by expression next to ctl.apply
    assert {"serve.begin", "serve.end", "serve.drain", "serve.restart", "req.submit",
            "req.timeout", "ctl.apply"} <= emitted
    assert emitted <= set(EVENT_KINDS)


# --------------------------------------------------------------------- #
# serve: the HTTP front-end


@pytest.fixture(scope="module")
def served(pair):
    """``serve_main`` on a thread with the module's port model and weights,
    bound to an ephemeral port."""
    holder, ready = {}, threading.Event()

    def cb(server, serving):
        holder.update(server=server, serving=serving)
        ready.set()

    t = threading.Thread(target=serve.serve_main, args=(
        ["--port", "0", "--dtype", "fp32", "--device", "cpu", "--max-new", "6",
         "--block-size", "8", "--max-running", "2"],),
        kwargs=dict(model=pair.pmodel, params=pair.pparams, ready_cb=cb), daemon=True)
    t.start()
    assert ready.wait(120), "serve never bound its socket"
    yield holder["server"].server_address[1]
    holder["server"].shutdown()
    t.join(120)


def _post(port, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn.getresponse()


def test_streamed_completion_end_to_end(pair, served):
    prompt = prompts((5,))[0]
    r = _post(served, {"prompt": [int(t) for t in prompt], "max_tokens": 6, "stream": True})
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    lines = r.read().decode().splitlines()
    assert "data: [DONE]" in lines
    chunks = [json.loads(x[6:]) for x in lines if x.startswith("data: ") and x != "data: [DONE]"]
    toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    np.testing.assert_array_equal(toks, pair.ref(prompt, 6)[len(prompt):])
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert all(c["object"] == "text_completion" for c in chunks)


def test_nonstream_completion_and_usage(pair, served):
    prompt = prompts((7,))[0]
    r = _post(served, {"prompt": [int(t) for t in prompt], "max_tokens": 6})
    assert r.status == 200
    body = json.loads(r.read())
    np.testing.assert_array_equal(body["choices"][0]["token_ids"],
                                  pair.ref(prompt, 6)[len(prompt):])
    assert body["usage"] == {"prompt_tokens": 7, "completion_tokens": 6, "total_tokens": 13}


def _status(port, body):
    """A POST's status, its body read (a response left unread makes the
    client's close a reset the server thread prints)."""
    r = _post(port, body)
    r.read()
    return r.status


def test_bad_requests(served):
    assert _status(served, {"prompt": "text"}) == 400
    assert _status(served, {"prompt": []}) == 400
    for bad in ({"max_tokens": "lots"}, {"ttft_budget": "fast"}, {"priority": [3]},
                {"max_tokens": 0}, {"deadline_ms": "soon"}, {"deadline_ms": 0}):
        assert _status(served, {"prompt": [1, 2], **bad}) == 400, bad
    assert _status(served, {"prompt": [1, 2], "max_tokens": 1}) == 200    # ticks the loop
    conn = http.client.HTTPConnection("127.0.0.1", served, timeout=60)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    assert health["state"] == "serving" and health["stopped"] is False
    assert set(health) == {"state", "stopped", "queue_depth", "running", "restarts",
                           "uptime_ticks"}
    assert health["restarts"] == 0 and health["uptime_ticks"] > 0
    conn2 = http.client.HTTPConnection("127.0.0.1", served, timeout=60)
    conn2.request("POST", "/nope", "{}")
    r = conn2.getresponse()
    r.read()
    assert r.status == 404


def test_cli_routes_serve():
    assert cli.COMMANDS["serve"] is cli._serve


def _health(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_healthz_503_once_stopped(pair):
    fresh(pair)
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=4, start=False)
    server = serve.build_http_server(serving, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        status, body = _health(port)
        assert status == 200 and body["state"] == "serving" and body["queue_depth"] == 0
        serving.drain()
        assert _health(port)[1]["state"] == "draining"
        serving.shutdown(drain=True)
        status, body = _health(port)
        assert status == 503 and body["state"] == "stopped" and body["stopped"] is True
    finally:
        server.shutdown()
        t.join(60)


def test_drain_vs_add_request_race_rejects(pair):
    """A submission appended before drain() but seen by the loop after it
    ends ``rejected`` (never served, never hung), in both packages."""
    _, hs, got, _ = both(pair, [("add", prompts((5,))[0]), ("drain",), ("drive",)], max_new=4)
    assert got["status"] == ["rejected"] and "draining" in hs[0].error


def test_metrics_route_parses_back_to_the_registry(pair):
    """``/metrics`` renders the registry through ``render_exposition``: a
    scrape parses back to the registry's serving counters."""
    from deepspeed_tpu_torch.monitor.top import snapshot_from_prometheus
    fresh(pair)
    serving = serve.AsyncServingEngine(pair.port, max_new_tokens=4)
    server = serve.build_http_server(serving, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        serving.add_request(prompts((5,))[0]).result(timeout=120)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200
        scraped = snapshot_from_prometheus(r.read().decode())
        snap = get_registry().snapshot()
        for k in ("serving/requests", "serving/finished_requests", "serving/decode_steps"):
            assert scraped["counters"][k] == snap["counters"][k] > 0
        serving.shutdown(drain=True, timeout=120)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        r.read()
        assert r.status == 503
    finally:
        server.shutdown()
        t.join(60)

