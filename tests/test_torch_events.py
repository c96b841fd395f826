"""The port's flight recorder, serving / fleet trace renderers, step tracer,
profile window and build watchdog (``deepspeed_tpu_torch/monitor``) against
the JAX package's: the same events go through both recorders and the
retained events must be equal; the same (fixed-timestamp) event lists must
render to identical chrome traces, which ``tools/validate_trace.py``
accepts. Adapts the JAX package's ``test_events.py`` classes
``TestFlightRecorder``, ``TestServingTraceRender``,
``TestStepTracerMetadata`` and ``TestProfileWindow``."""

import importlib.util
import json
import threading
from collections import Counter
from pathlib import Path

import pytest
import torch

from deepspeed_tpu.monitor import events as jax_events
from deepspeed_tpu_torch.monitor import events as port_events
from deepspeed_tpu_torch.monitor.events import EVENT_KINDS, FlightRecorder
from deepspeed_tpu_torch.monitor.trace import (CompileWatchdog, ProfileWindow, StepTracer,
                                               get_compile_watchdog)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

_VT_PATH = Path(__file__).resolve().parents[1] / "tools" / "validate_trace.py"
_spec = importlib.util.spec_from_file_location("validate_trace", _VT_PATH)
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)


def _recorded(mod, ops, **kw):
    rec = mod.FlightRecorder(**kw)
    ops(rec)
    return rec


def _drop_ts(rec):
    return [{k: v for k, v in e.to_dict().items() if k != "ts_ns"} for e in rec.snapshot()]


def _ops_ring(r):
    for i in range(7):
        r.emit("req.enqueue", rid=i, prompt_tokens=1, max_new=1)


def _ops_explicit_start(r):
    r.emit("serve.begin", requests=1)
    r.emit("serve.end", t_ns=123, dur_ns=45, requests=1)


def _ops_resize(r):
    for i in range(6):
        r.emit("req.enqueue", rid=i, prompt_tokens=1, max_new=1)
    r.enable(capacity=3)


RECORDER_CASES = {"ring": (_ops_ring, {"capacity": 4, "enabled": True}),
                  "explicit_start": (_ops_explicit_start, {"enabled": True}),
                  "resize": (_ops_resize, {"capacity": 8, "enabled": True})}


def test_event_catalogue_is_the_jax_packages():
    assert EVENT_KINDS == jax_events.EVENT_KINDS
    assert "req.admit" in EVENT_KINDS


@pytest.mark.parametrize("name", sorted(RECORDER_CASES))
def test_same_emits_same_retained_events(name):
    ops, kw = RECORDER_CASES[name]
    j, p = _recorded(jax_events, ops, **kw), _recorded(port_events, ops, **kw)
    assert _drop_ts(p) == _drop_ts(j)
    assert (len(p), p.dropped, p.capacity) == (len(j), j.dropped, j.capacity)


def test_ring_bound_drop_counter_and_typed_kinds():
    r = _recorded(port_events, _ops_ring, capacity=4, enabled=True)
    assert len(r) == 4 and r.dropped == 3
    assert [e.rid for e in r.snapshot()] == [3, 4, 5, 6]     # the tail survives
    r.clear()
    assert len(r) == 0 and r.dropped == 0
    with pytest.raises(ValueError, match="unknown event kind"):
        r.emit("req.not_a_kind")
    r = _recorded(port_events, _ops_explicit_start, enabled=True)
    a, b = r.snapshot()
    assert a.ts_ns > 0 and b.ts_ns == 123 and b.dur_ns == 45
    assert b.to_dict() == {"ts_ns": 123, "kind": "serve.end", "dur_ns": 45, "requests": 1}
    r = _recorded(port_events, _ops_resize, capacity=8, enabled=True)
    assert [e.rid for e in r.snapshot()] == [3, 4, 5]


def test_disabled_emit_is_flag_check_no_allocation(monkeypatch):
    r = FlightRecorder(enabled=False)

    def boom(*a, **k):
        raise AssertionError("Event allocated in disabled mode")

    monkeypatch.setattr(port_events, "Event", boom)
    for _ in range(100):
        r.emit("req.admit", rid=0, cached_tokens=0)
    assert len(r) == 0 and r.dropped == 0


def test_thread_safety_under_concurrent_emit():
    r = FlightRecorder(capacity=256, enabled=True)

    def work(tid):
        for i in range(500):
            r.emit("req.enqueue", rid=tid * 1000 + i, prompt_tokens=1, max_new=1)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(r) == 256 and r.dropped == 4 * 500 - 256


def test_write_jsonl_roundtrip_validates(tmp_path):
    r = FlightRecorder(capacity=3, enabled=True)
    for i in range(5):
        r.emit("req.enqueue", rid=i, prompt_tokens=2, max_new=1)
    p = r.write_jsonl(str(tmp_path / "events.jsonl"))
    lines = Path(p).read_text().splitlines()
    head = json.loads(lines[0])
    assert head == {"ts_ns": head["ts_ns"], "kind": "recorder.dropped", "count": 2}
    assert len(lines) == 4
    assert validate_trace.validate_path(p) == []


# --------------------------------------------------------------------- #
# chrome-trace rendering: identical documents from identical events


def _evs(mod, rows):
    out = []
    for kind, ts, kw in rows:
        data = {k: v for k, v in kw.items() if k not in ("rid", "step", "dur_ns")}
        out.append(mod.Event(ts_ns=ts, kind=kind, rid=kw.get("rid"), step=kw.get("step"),
                             dur_ns=kw.get("dur_ns"), data=data or None))
    return out


PREEMPTED = [
    ("req.enqueue", 100, dict(rid=0, prompt_tokens=4)),
    ("req.admit", 200, dict(rid=0, cached_tokens=0, blocks=1)),
    ("req.prefill", 300, dict(rid=0, dur_ns=50, tokens=4)),
    ("req.preempt", 400, dict(rid=0, blocks=1, recompute_tokens=5)),
    ("req.admit", 500, dict(rid=0, cached_tokens=0, blocks=2)),
    ("decode.tick", 600, dict(dur_ns=40, rids=[0], n=1)),
    ("req.retire", 700, dict(rid=0, generated=3, preemptions=1)),
]
INCOMPLETE = [
    ("req.admit", 10, dict(rid=7, cached_tokens=0, blocks=1)),
    ("sched.gauge", 20, dict(queued=2, running=1, kv_used=3, kv_free=4)),
    ("decode.tick", 30, dict(dur_ns=5, rids=[7], n=1)),
]
SPEC_AND_COW = [
    ("serve.begin", 0, dict(requests=2)),
    ("req.enqueue", 5, dict(rid=1, prompt_tokens=9, max_new=4)),
    ("req.enqueue", 6, dict(rid=2, prompt_tokens=9, max_new=4)),
    ("req.cache_hit", 10, dict(rid=1, tokens=8, host_blocks=0)),
    ("req.admit", 10, dict(rid=1, cached_tokens=8, blocks=2, prefill_target=9)),
    ("req.phase", 10, dict(rid=1, phase="queue", dur_ns=4)),
    ("req.cow_copy", 11, dict(rid=1, dur_ns=3, src=0, dst=3)),
    ("req.prefill_chunk", 15, dict(rid=1, dur_ns=9, start=8, tokens=1)),
    ("req.cache_miss", 30, dict(rid=2)),
    ("req.admit", 30, dict(rid=2, cached_tokens=0, blocks=2, prefill_target=9)),
    ("req.prefill", 31, dict(rid=2, dur_ns=20, tokens=9)),
    ("req.spec_propose", 55, dict(rid=1, dur_ns=1, tokens=2, found=2)),
    ("req.spec_verify", 60, dict(rid=1, dur_ns=10, window=3, accepted=1)),
    ("req.spec_verify", 60, dict(rid=2, dur_ns=10, window=1, accepted=0)),
    ("req.spec_rollback", 71, dict(rid=1, rejected=1, unregistered=0)),
    ("sched.gauge", 72, dict(queued=0, running=2, kv_used=4, kv_free=1)),
    ("req.retire", 80, dict(rid=1, generated=4, preemptions=0)),
    ("req.retire", 81, dict(rid=2, generated=4, preemptions=0)),
    ("serve.end", 0, dict(dur_ns=90, requests=2)),
]
RENDER_CASES = {"preempted": PREEMPTED, "incomplete": INCOMPLETE,
                "spec_and_cow": SPEC_AND_COW, "empty": []}


@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_serving_trace_renders_identically_and_validates(name, tmp_path):
    rows = RENDER_CASES[name]
    doc = port_events.render_serving_trace(_evs(port_events, rows))
    assert doc == jax_events.render_serving_trace(_evs(jax_events, rows))
    assert validate_trace.validate_chrome_trace(doc) == []
    path = port_events.export_serving_trace(_evs(port_events, rows),
                                            str(tmp_path / "serve.json"))
    assert validate_trace.validate_path(path, kind="chrome") == []


def test_serving_trace_spans_counters_and_incomplete():
    doc = port_events.render_serving_trace(_evs(port_events, PREEMPTED))
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "request"]
    assert len(spans) == 1
    assert spans[0]["ts"] == pytest.approx(0.1) and spans[0]["dur"] == pytest.approx(0.5)
    assert spans[0]["args"]["preemptions"] == 1
    names = Counter(e["name"] for e in doc["traceEvents"]
                    if e["ph"] == "X" and e.get("cat") != "request")
    assert names["prefill"] == 1 and names["decode"] == 1
    doc = port_events.render_serving_trace(_evs(port_events, INCOMPLETE))
    counters = {e["name"]: e["args"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert counters["queue_depth"] == {"queued": 2, "running": 1}
    assert counters["kv_blocks"] == {"used": 3, "free": 4}
    span = next(e for e in doc["traceEvents"] if e.get("cat") == "request")
    assert span["args"]["incomplete"] is True


def _fleet_rows():
    """Two replicas through tagged recorders on one ring, a handoff chained
    by a trace id."""
    rows = []
    for rep, rid, base, trace in (("r0", 0, 0, "t1"), ("r1", 0, 1000, "t1"),
                                  ("r1", 1, 1100, None)):
        enq = dict(rid=rid, prompt_tokens=4, max_new=2, replica=rep)
        if trace:
            enq["trace"] = trace
        rows += [("req.enqueue", base, enq),
                 ("req.admit", base + 10, dict(rid=rid, cached_tokens=0, blocks=1,
                                               replica=rep)),
                 ("req.prefill", base + 20, dict(rid=rid, dur_ns=30, tokens=4, replica=rep)),
                 ("req.retire", base + 90, dict(rid=rid, generated=2, preemptions=0,
                                                replica=rep))]
    rows.append(("serve.route", 5, dict(seq=0, replica="r0", reason="prefill")))
    rows.append(("serve.handoff", 500, dict(trace="t1", from_replica="r0", to_replica="r1")))
    return sorted(rows, key=lambda r: r[1])


def test_fleet_trace_renders_identically_and_validates(tmp_path):
    rows = _fleet_rows()
    doc = port_events.render_fleet_trace(_evs(port_events, rows))
    assert doc == jax_events.render_fleet_trace(_evs(jax_events, rows))
    assert validate_trace.validate_chrome_trace(doc) == []
    assert {e["ph"] for e in doc["traceEvents"]} >= {"s", "f"}     # the handoff arrow
    rec = FlightRecorder(enabled=True)
    r0, r1 = port_events.TaggedRecorder(rec, "r0"), port_events.TaggedRecorder(rec, "r1")
    r0.emit("req.enqueue", rid=0, prompt_tokens=1, max_new=1)
    r1.emit("req.enqueue", rid=0, prompt_tokens=1, max_new=1, replica="named")
    assert [e.data["replica"] for e in rec.snapshot()] == ["r0", "named"]
    path = port_events.export_fleet_trace([r0, r1], str(tmp_path / "fleet.json"))
    assert validate_trace.validate_path(path, kind="chrome") == []


def test_dump_events_jsonl(tmp_path):
    rec = port_events.get_flight_recorder()
    was = rec.enabled
    rec.clear()
    try:
        rec.disable()
        assert port_events.dump_events_jsonl(str(tmp_path)) is None
        rec.enable()
        rec.emit("train.step", step=1, dur_ns=5)
        path = port_events.dump_events_jsonl(str(tmp_path))
        assert path == str(tmp_path / "events.jsonl")
        assert validate_trace.validate_path(path, kind="events") == []
    finally:
        rec.clear()
        rec.enabled = was


# --------------------------------------------------------------------- #
# step tracer, profile window, build watchdog


def test_step_tracer_export_names_pid_and_tid_tracks(tmp_path):
    tracer = StepTracer(use_accelerator=False)
    with tracer.span("fwd", micro=0):
        pass
    path = tracer.export_chrome_trace(str(tmp_path / "host.json"))
    assert validate_trace.validate_path(path) == []
    doc = json.loads(Path(path).read_text())
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    procs = [e for e in metas if e["name"] == "process_name"]
    threads = [e for e in metas if e["name"] == "thread_name"]
    assert procs[0]["args"]["name"] == "deepspeed_tpu host"
    assert threads and threads[0]["args"]["name"] == "MainThread"
    span = next(e for e in doc["traceEvents"] if e["ph"] == "X")
    assert span["tid"] == threads[0]["tid"] and span["args"] == {"micro": "0"}


def test_step_tracer_pushes_accelerator_ranges(monkeypatch):
    from deepspeed_tpu_torch.accelerator.cuda_accelerator import CPU_Accelerator
    calls = []
    monkeypatch.setattr(CPU_Accelerator, "range_push", lambda self, n: calls.append(("push", n)))
    monkeypatch.setattr(CPU_Accelerator, "range_pop", lambda self: calls.append(("pop",)))
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    with StepTracer().span("bwd"):
        calls.append("body")
    assert calls == [("push", "bwd"), "body", ("pop",)]


class _FakeProfile:
    calls = []

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        self.calls.append("start")
        return self

    def __exit__(self, *exc):
        self.calls.append("stop")

    def export_chrome_trace(self, path):
        self.calls.append(("export", Path(path).name))
        Path(path).write_text('{"traceEvents": []}')


@pytest.fixture
def fake_profiler(monkeypatch):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile.calls


def test_profile_window_arms_starts_and_stops(fake_profiler, tmp_path):
    w = ProfileWindow(str(tmp_path / "a"))
    w.tick()                        # nothing armed: no-op
    w.arm(2, log_dir=str(tmp_path / "b"))
    for _ in range(4):
        w.tick()
    assert fake_profiler == ["start", "stop", ("export", "trace_0.json")]
    assert w.captures == 1 and not w.active and (tmp_path / "b" / "trace_0.json").exists()
    with pytest.raises(ValueError, match=">= 1"):
        w.arm(0)


def test_profile_window_config_armed_with_start_step(fake_profiler, tmp_path):
    w = ProfileWindow(str(tmp_path), start_step=2, num_steps=1)
    w.tick()
    w.tick()
    assert fake_profiler == []
    w.tick()
    assert fake_profiler == ["start"] and w.active
    w.tick()
    assert fake_profiler[1] == "stop" and not w.active


def test_build_watchdog_records_builds_and_keeps_the_jax_summary_keys():
    from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry
    reg = MetricsRegistry()
    wd = CompileWatchdog(registry=reg)
    fn = object()
    assert wd.watch(fn, "x") is fn
    wd.record_build("paged_decode_attention", 1.5)
    wd.record_build("paged_decode_attention", 0.5)
    s = wd.summary()
    assert set(s) == {"total", "by_fn", "events"}
    assert s["total"] == 2 and s["by_fn"] == {"paged_decode_attention": 2}
    assert s["events"][0]["wall_time_s"] == 1.5
    snap = reg.snapshot()
    assert snap["counters"]['compile/count{fn="paged_decode_attention"}'] == 2
    assert snap["histograms"]['compile/time_ms{fn="paged_decode_attention"}']["sum"] == 2000.0
    assert get_compile_watchdog() is get_compile_watchdog()
