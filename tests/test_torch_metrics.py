"""The port's metrics registry (``deepspeed_tpu_torch/monitor/metrics.py``)
against the JAX package's: the same sequence of registry operations goes
through both, and the snapshots must be equal and the Prometheus text
(with and without exemplars) identical. Each case then checks the port's
registry as the JAX package's own tests check theirs
(``test_telemetry.py::TestMetricsRegistry``,
``test_observability.py::TestPrometheusExposition``, ``TestSummaryAtomicity``
and ``TestRecorderMetrics``)."""

import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.monitor import events as jax_events
from deepspeed_tpu.monitor import metrics as jax_metrics
from deepspeed_tpu_torch.monitor import events as port_events
from deepspeed_tpu_torch.monitor import metrics as port_metrics
from deepspeed_tpu_torch.monitor.metrics import (MetricsRegistry, parse_prometheus_text,
                                                 validate_snapshot)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def _ops_counters(reg):
    c = reg.counter("reqs")
    c.inc()
    c.inc(2.5)
    lc = reg.counter("ops", labelnames=("op",))
    lc.labels(op="a").inc()
    lc.labels(op="b").inc(4)
    lc.labels(op="a").inc()


def _ops_gauge(reg):
    g = reg.gauge("depth")
    g.set(7)
    g.inc()
    g.dec(3)


def _ops_lognormal(reg):
    h = reg.histogram("lat")
    for v in np.random.default_rng(0).lognormal(mean=2.0, sigma=1.0, size=4000):
        h.observe(float(v))


def _ops_single(reg):
    reg.histogram("empty")
    reg.histogram("lat").observe(5.0)


def _ops_exposition(reg):
    reg.counter("train/steps", "steps run").inc(3)
    reg.gauge("train/mfu").set(0.5)
    reg.histogram("lat_ms", labelnames=("op",)).labels(op="ar").observe(10.0)
    reg.counter("serving/requests", "total").inc(3)
    reg.gauge("mem/hbm-bytes.in use").set(1)


def _ops_escaping(reg):
    reg.gauge("health/anomalies", "by type",
              labelnames=("type",)).labels(type='we"ird\\path\nnewline').set(7)


def _ops_buckets(reg):
    h = reg.histogram("serving/ttft_ms", "ttft")
    for v in (0.5, 3.0, 3.0, 40.0, 900.0):
        h.observe(v)
    fam = reg.histogram("train/phase_time_ms", "phases", labelnames=("phase",))
    fam.labels(phase="fwd").observe(3.0)
    fam.labels(phase="bwd").observe(7.0)


def _ops_exemplar(reg):
    h = reg.histogram("serving/ttft_ms", "ttft")
    h.observe(5.0, exemplar={"rid": "3"})
    h.observe(500.0, exemplar={"rid": "17"})     # the newest exemplar wins


def _ops_recorder(reg, events_mod):
    rec = events_mod.FlightRecorder(capacity=4, enabled=True)
    for i in range(10):
        rec.emit("train.step", step=i)
    events_mod.export_recorder_metrics(reg, rec)
    events_mod.export_recorder_metrics(reg, events_mod.FlightRecorder(enabled=False))


CASES = {
    "counters": _ops_counters, "gauge": _ops_gauge, "lognormal": _ops_lognormal,
    "single": _ops_single, "exposition": _ops_exposition, "escaping": _ops_escaping,
    "buckets": _ops_buckets, "exemplar": _ops_exemplar,
}


def _both(ops):
    jreg, preg = jax_metrics.MetricsRegistry(), MetricsRegistry()
    ops(jreg)
    ops(preg)
    return jreg, preg


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_operations_same_snapshot_and_exposition(name):
    jreg, preg = _both(CASES[name])
    snap = preg.snapshot()
    validate_snapshot(snap)
    assert snap == jreg.snapshot()
    assert preg.to_prometheus() == jreg.to_prometheus()
    assert preg.to_prometheus(exemplars=True) == jreg.to_prometheus(exemplars=True)
    assert parse_prometheus_text(preg.to_prometheus()) == \
        jax_metrics.parse_prometheus_text(jreg.to_prometheus())


def test_counter_gauge_labels_and_type_checks():
    reg = MetricsRegistry()
    _ops_counters(reg)
    _ops_gauge(reg)
    snap = reg.snapshot()
    assert snap["counters"]["reqs"] == 3.5
    assert snap["counters"]['ops{op="a"}'] == 2 and snap["counters"]['ops{op="b"}'] == 4
    assert snap["gauges"]["depth"] == 5.0
    with pytest.raises(ValueError, match="negative"):
        reg.counter("reqs").inc(-1)
    with pytest.raises(ValueError, match="labels"):
        reg.counter("ops", labelnames=("op",)).labels(wrong="x")
    with pytest.raises(ValueError, match="re-registered"):
        reg.gauge("reqs")


def test_histogram_streaming_quantiles():
    reg = MetricsRegistry()
    _ops_lognormal(reg)
    data = np.random.default_rng(0).lognormal(mean=2.0, sigma=1.0, size=4000)
    s = reg.histogram("lat").summary()
    assert s["count"] == 4000
    assert s["min"] == pytest.approx(data.min()) and s["max"] == pytest.approx(data.max())
    assert s["mean"] == pytest.approx(data.mean(), rel=1e-6)
    for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        assert s[key] == pytest.approx(np.percentile(data, q * 100), rel=0.15)
    reg2 = MetricsRegistry()
    _ops_single(reg2)
    assert reg2.histogram("empty").summary()["count"] == 0
    assert reg2.histogram("lat").summary()["p50"] == pytest.approx(5.0)


def test_prometheus_names_labels_and_buckets():
    reg = MetricsRegistry()
    _ops_exposition(reg)
    text = reg.to_prometheus()
    for want in ("# TYPE train_steps counter", "train_steps 3", "# HELP train_steps steps run",
                 "train_mfu 0.5", "# TYPE lat_ms histogram",
                 'lat_ms_bucket{op="ar",le="+Inf"} 1', 'lat_ms_count{op="ar"} 1',
                 "serving_requests 3", "mem_hbm_bytes_in_use 1"):
        assert want in text
    for line in text.splitlines():
        if not line.startswith("#"):
            assert "/" not in line.split("{")[0]
    reg = MetricsRegistry()
    _ops_escaping(reg)
    txt = reg.to_prometheus()
    line = [ln for ln in txt.splitlines() if ln.startswith("health_anomalies{")][0]
    assert '\\"' in line and "\\\\" in line and "\\n" in line
    assert parse_prometheus_text(txt)["gauges"][
        'health_anomalies{type="we"ird\\path\nnewline"}'] == 7.0
    reg = MetricsRegistry()
    _ops_buckets(reg)
    txt = reg.to_prometheus()
    buckets = []
    for ln in txt.splitlines():
        if ln.startswith("serving_ttft_ms_bucket{"):
            le = ln.split('le="')[1].split('"')[0]
            buckets.append((math.inf if le == "+Inf" else float(le),
                            int(ln.split("} ")[1].split(" #")[0])))
    assert buckets == sorted(buckets) and buckets[-1] == (math.inf, 5)
    snap = parse_prometheus_text(txt)
    h = reg.histogram("serving/ttft_ms")
    s = snap["histograms"]["serving_ttft_ms"]
    assert s["count"] == 5 and s["sum"] == pytest.approx(946.5)
    assert s["p50"] == pytest.approx(h.quantile(0.5), rel=0.25)
    assert snap["histograms"]['train_phase_time_ms{phase="bwd"}']["sum"] == pytest.approx(7.0)


def test_exemplar_rides_its_bucket_only_when_asked():
    reg = MetricsRegistry()
    _ops_exemplar(reg)
    assert " # {" not in reg.to_prometheus()
    txt = reg.to_prometheus(exemplars=True)
    ex = [ln for ln in txt.splitlines() if " # {" in ln]
    assert len(ex) == 1 and 'rid="17"' in ex[0] and ex[0].endswith(" 500")
    assert float(ex[0].split('le="')[1].split('"')[0]) >= 500.0
    assert parse_prometheus_text(txt)["histograms"]["serving_ttft_ms"]["count"] == 2


def test_parser_survives_foreign_lines_and_schema_validation():
    txt = ("# some comment\nweird{ 1\nup 1\n# TYPE go_goroutines gauge\ngo_goroutines 42\n")
    snap = parse_prometheus_text(txt)
    assert snap == jax_metrics.parse_prometheus_text(txt)
    assert snap["gauges"]["go_goroutines"] == 42.0
    validate_snapshot(snap)
    with pytest.raises(ValueError, match="section"):
        validate_snapshot({"counters": {}})
    with pytest.raises(ValueError, match="not numeric"):
        validate_snapshot({"counters": {"x": "nan?"}, "gauges": {}, "histograms": {}})


def test_jsonl_sink_and_monitor_fanout(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc()
    path = str(tmp_path / "t" / "telemetry.jsonl")
    reg.write_jsonl(path, step=1)
    reg.counter("c").inc()
    reg.write_jsonl(path, step=2, extra={"tag": "x"})
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["counters"]["c"] for ln in lines] == [1, 2] and lines[1]["tag"] == "x"
    for ln in lines:
        validate_snapshot(ln)

    class FakeMonitor:
        enabled = True

        def __init__(self):
            self.events = []

        def write_events(self, ev):
            self.events.extend(ev)

    reg = MetricsRegistry()
    reg.counter("c").inc(2)
    reg.gauge("g").set(1.5)
    reg.histogram("h").observe(4.0)
    jreg = jax_metrics.MetricsRegistry()
    jreg.counter("c").inc(2)
    jreg.gauge("g").set(1.5)
    jreg.histogram("h").observe(4.0)
    mon, jmon = FakeMonitor(), FakeMonitor()
    reg.publish(mon, step=7)
    jreg.publish(jmon, step=7)
    assert mon.events == jmon.events
    assert ("Telemetry/c", 2.0, 7) in mon.events and ("Telemetry/g", 1.5, 7) in mon.events


def test_disabled_mode_is_a_flag_check():
    reg = MetricsRegistry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    for _ in range(100):
        c.inc()
        g.set(1.0)
        h.observe(3.3)
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 0 and snap["gauges"]["g"] == 0.0
    assert snap["histograms"]["h"]["count"] == 0
    reg.set_enabled(True)
    c.inc()
    assert reg.snapshot()["counters"]["c"] == 1


def test_summary_never_torn_under_concurrent_observe():
    """One registry-lock hold for the whole summary: a concurrent observe
    never yields p50 > max, or quantiles from different instants."""
    h = MetricsRegistry().histogram("t/h", "x")
    stop = threading.Event()

    def writer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            h.observe(float(rng.choice([1e-3, 1e6])))

    threads = [threading.Thread(target=writer, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            s = h.summary()
            if s["count"] == 0:
                continue
            assert s["min"] <= s["p50"] <= s["p90"] <= s["p99"] <= s["max"]
            assert s["min"] <= s["mean"] <= s["max"]
            assert s["mean"] == pytest.approx(s["sum"] / s["count"])
    finally:
        stop.set()
        for t in threads:
            t.join(5)


def test_recorder_ring_loss_gauges():
    jreg, preg = jax_metrics.MetricsRegistry(), MetricsRegistry()
    _ops_recorder(jreg, jax_events)
    _ops_recorder(preg, port_events)
    snap = preg.snapshot()
    assert snap == jreg.snapshot()
    assert snap["gauges"] == {"events/capacity": 4, "events/dropped": 6}
    empty = MetricsRegistry()
    port_events.export_recorder_metrics(empty, port_events.FlightRecorder(enabled=False))
    assert empty.snapshot()["gauges"] == {}


def test_global_registry_is_one_per_process():
    assert port_metrics.get_registry() is port_metrics.get_registry()
    assert port_metrics.get_registry() is not jax_metrics.get_registry()


# --------------------------------------------------------------------- #
# the telemetry section: the JAX package's shorthands and implications

TELEMETRY_SECTIONS = [
    None, "on", "off", True, False, 1, {},
    {"enabled": True, "steps_per_snapshot": 5, "jsonl_path": "t.jsonl"},
    {"events": True}, {"events": "on", "enabled": False}, {"events": {"capacity": 64}},
    {"health": True}, {"health": {"enabled": True, "window": 7}},
    {"slo": {"enabled": True, "objectives": [{"name": "ttft", "kind": "latency"}]}},
    {"ctl": "on"}, {"sampler": None, "profile": None}, {"metrics_port": 0},
    {"profile": {"num_steps": 2, "start_step": 1, "dir": "p"}, "peak_tflops_per_chip": 9.5},
]


def _fields(cfg):
    import dataclasses
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("section", TELEMETRY_SECTIONS, ids=repr)
def test_telemetry_section_parses_as_in_the_jax_package(section):
    from deepspeed_tpu.monitor.config import get_telemetry_config as jax_parse
    from deepspeed_tpu_torch.monitor.config import get_telemetry_config
    got = _fields(get_telemetry_config({"telemetry": section}))
    want = jax_parse({"telemetry": section}).model_dump()
    assert got == want


def test_telemetry_section_rejects_bad_shorthands_and_refuses_the_control_plane():
    """Bad shorthands raise; the control-plane sections parse on both
    engines. None is refused any more: the training engine acts on health,
    the sampler, the SLOs and the exporter, as the JAX one does, and
    neither engine acts on ctl (the controller runs beside the async
    serving loop, from ``serve --adaptive``)."""
    from deepspeed_tpu_torch.monitor.config import get_telemetry_config
    with pytest.raises(ValueError, match="telemetry"):
        get_telemetry_config({"telemetry": "sometimes"})
    with pytest.raises(ValueError, match="telemetry.events"):
        get_telemetry_config({"telemetry": {"events": "maybe"}})
    for section, field in (({"sampler": True}, "sampler"), ({"slo": {"enabled": True}}, "slo"),
                           ({"ctl": True}, "ctl"), ({"health": True}, "health")):
        tcfg = get_telemetry_config({"telemetry": section})
        assert tcfg.enabled and getattr(tcfg, field).enabled
    tcfg = get_telemetry_config({"telemetry": {"metrics_port": 9100}})
    assert tcfg.enabled and tcfg.metrics_port == 9100
    assert not get_telemetry_config({"telemetry": {"enabled": False, "ctl": True}}).enabled
    # ctl implies the sampler, as in the JAX config
    assert get_telemetry_config({"telemetry": {"ctl": {"enabled": True}}}).sampler.enabled