"""Serving telemetry in the port against the JAX engine's, on the CPU: the
same tiny model and prompts served by ``generate_batch`` with
``telemetry={"events": True}`` through both packages (the JAX engine on a
one-device mesh with ``attention_backend="flash"``, its Pallas kernels in
interpret mode). Two traces: prefix caching with a forced preemption and a
full-prefix re-hit (copy-on-write), and n-gram speculation on prompts whose
seeded continuations roll back. The flight-recorder streams must be equal
event for event on (kind, rid, data), the serving counters and gauges
equal and the histogram counts equal; both exported traces must pass
``tools/validate_trace.py``. In the port, telemetry on or off must give
the same tokens and the same number of host syncs, and off must allocate
no event and no telemetry object."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
import deepspeed_tpu_torch.accelerator.abstract_accelerator as port_acc
from deepspeed_tpu.monitor import events as jax_events
from deepspeed_tpu.monitor import metrics as jax_metrics
from deepspeed_tpu_torch.inference import scheduler as port_sched
from deepspeed_tpu_torch.monitor import events as port_events
from deepspeed_tpu_torch.monitor import metrics as port_metrics
from tests.test_torch_serving import _Pair, _prompts, one_device_mesh  # noqa: F401 (fixture)

_VT_PATH = Path(__file__).resolve().parents[1] / "tools" / "validate_trace.py"
_spec = importlib.util.spec_from_file_location("validate_trace", _VT_PATH)
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)

TELEMETRY = {"events": True}


def _reset_globals():
    for mod in (jax_metrics, port_metrics):
        mod.get_registry().reset()
        mod.get_registry().set_enabled(True)
    for mod in (jax_events, port_events):
        rec = mod.get_flight_recorder()
        rec.disable()
        rec.clear()


def _cache_preempt_calls():
    """Two requests that outgrow a 3-block pool (one preemption a call; the
    second call re-hits the first's cached blocks), then a one-block prompt
    served twice (a full-prefix hit: copy-on-write and a tail chunk)."""
    pressure = _prompts(3, (120, 110))
    whole = _prompts(9, (128,))
    return [(pressure, 20), (pressure, 20), (whole, 4), (whole, 4)]


def _spec_calls():
    r = np.random.default_rng(2)     # seeded prompts whose verify steps roll back
    return [([np.tile(r.integers(0, 64, size=n), 4).astype(np.int32) for n in (3, 7)], 16)]


SCENARIOS = {
    "cache_preempt": ({"block_size": 128, "max_running": 2, "max_num_blocks": 4},
                      _cache_preempt_calls),
    "spec": ({"block_size": 128, "max_running": 2,
              "speculative": {"mode": "ngram", "k": 3}}, _spec_calls),
}


def _serve(engine, calls):
    return [[np.asarray(t) for t in engine.generate_batch(p, max_new_tokens=n)]
            for p, n in calls]


class _Run:
    """One scenario through both packages with telemetry on, and through
    the port with it off."""

    def __init__(self, pair, name, tmp):
        self.name = name
        srv, calls_fn = SCENARIOS[name]
        calls = calls_fn()
        _reset_globals()
        jeng = deepspeed_tpu.init_inference(pair.jmodel, params=pair.jparams, dtype="fp32",
                                            serving=srv, telemetry=TELEMETRY)
        peng = deepspeed_tpu_torch.init_inference(pair.pmodel, params=pair.params,
                                                  dtype="fp32", device="cpu", serving=srv,
                                                  telemetry=TELEMETRY)
        self.jax_out = _serve(jeng, calls)
        s0 = port_acc.syncs
        self.port_out = _serve(peng, calls)
        self.syncs_on = port_acc.syncs - s0
        self.jax_events = jax_events.get_flight_recorder().snapshot()
        self.port_events = port_events.get_flight_recorder().snapshot()
        self.jax_snap = jeng.telemetry_snapshot()
        self.port_snap = peng.telemetry_snapshot()
        self.jax_trace = jeng.export_serving_trace(str(tmp / "jax_trace.json"))
        self.port_trace = peng.export_serving_trace(str(tmp / "port_trace.json"))
        self.stats = peng._last_serve_stats
        self.n_requests = sum(len(p) for p, _ in calls)
        _reset_globals()
        off = deepspeed_tpu_torch.init_inference(pair.pmodel, params=pair.params,
                                                 dtype="fp32", device="cpu", serving=srv)
        s0 = port_acc.syncs
        self.off_out = _serve(off, calls)
        self.syncs_off = port_acc.syncs - s0
        self.off_engine, self.calls = off, calls
        _reset_globals()


@pytest.fixture(scope="module")
def pair(one_device_mesh):
    return _Pair("llama")


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def run(request, pair, tmp_path_factory):
    return _Run(pair, request.param, tmp_path_factory.mktemp(request.param))


def _stream(events):
    return [(e.kind, e.rid, e.data) for e in events]


def test_event_streams_equal_in_order(run):
    assert [np.array_equal(a, b) for c, d in zip(run.jax_out, run.port_out)
            for a, b in zip(c, d)] == [True] * run.n_requests
    assert _stream(run.port_events) == _stream(run.jax_events)
    kinds = {e.kind for e in run.port_events}
    if run.name == "spec":
        assert {"req.spec_propose", "req.spec_verify", "req.spec_rollback"} <= kinds
    else:
        assert {"req.preempt", "req.cache_hit", "req.cow_copy", "req.prefill_chunk",
                "decode.tick"} <= kinds


def _serving(snap, section):
    return {k: v for k, v in snap[section].items() if not k.startswith("compile/")}


def test_registry_series_equal(run):
    for section in ("counters", "gauges"):
        got = {k: v for k, v in _serving(run.port_snap, section).items()
               if not k.startswith("mem/")}
        want = {k: v for k, v in _serving(run.jax_snap, section).items()
                if not k.startswith("mem/")}
        assert got == want, section
    counts = {k: v["count"] for k, v in _serving(run.port_snap, "histograms").items()}
    assert counts == {k: v["count"] for k, v in _serving(run.jax_snap, "histograms").items()}
    assert counts["serving/ttft_ms"] == run.n_requests
    c = run.port_snap["counters"]
    assert c["serving/requests"] == c["serving/finished_requests"] == run.n_requests
    assert len(port_sched.ServingTelemetry._SERIES) == 41
    if run.name == "spec":
        assert c["serving/spec_rollbacks"] > 0
        assert c["serving/spec_rollbacks"] == run.stats["spec_rollbacks"]
    else:
        assert c["serving/preemptions"] > 0 and c["serving/recompute_tokens"] > 0
        assert c["serving/prefix_cache_hits"] > 0
    for unported in ("serving/timeouts", "serving/shed_requests", "serving/request_retries",
                     "serving/kv_spills", "serving/engine_restarts"):
        assert c[unported] == 0


def test_exported_traces_validate(run):
    for path in (run.jax_trace, run.port_trace):
        assert validate_trace.validate_path(path, kind="chrome") == []


def test_telemetry_changes_no_token_and_adds_no_sync(run):
    for on, off in zip(run.port_out, run.off_out):
        for a, b in zip(on, off):
            np.testing.assert_array_equal(a, b)
    assert run.syncs_on == run.syncs_off > 0


def test_disabled_telemetry_allocates_nothing(run, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("telemetry allocated with telemetry off")

    monkeypatch.setattr(port_events, "Event", boom)
    monkeypatch.setattr(port_sched.ServingTelemetry, "__init__", boom)
    rec = port_events.get_flight_recorder()
    eng = run.off_engine
    assert eng._events is None and eng._serving_tel is None
    assert eng.telemetry_snapshot() == {}
    out = _serve(eng, run.calls[:1])
    assert all(np.array_equal(a, b) for a, b in zip(out[0], run.off_out[0]))
    assert len(rec) == 0
    with pytest.raises(ValueError, match="flight recorder"):
        eng.export_serving_trace("unused.json")


def test_set_replica_tags_events_and_labels(pair):
    _reset_globals()
    try:
        srv = {"block_size": 128, "max_running": 2}
        eng = deepspeed_tpu_torch.init_inference(pair.pmodel, params=pair.params,
                                                 dtype="fp32", device="cpu", serving=srv,
                                                 telemetry=TELEMETRY)
        eng.set_replica("r7")
        eng.generate_batch(_prompts(4, (5,)), max_new_tokens=2)
        evs = port_events.get_flight_recorder().snapshot()
        assert evs and {e.data.get("replica") for e in evs} == {"r7"}
        snap = eng.telemetry_snapshot()
        assert any('replica="r7"' in k for k in snap["histograms"])
        assert set(snap["compile"]) == {"total", "by_fn", "events"}
    finally:
        _reset_globals()
