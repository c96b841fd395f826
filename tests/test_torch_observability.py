"""The port's exposition plane against the JAX package's: the ``/metrics``
exporter (the same exposition text for the same registry contents, the
OpenMetrics negotiation, ``/healthz``, a 404, refused connections after
``stop``), the sampler (ticks, JSONL, rotation, the config shorthands), the
SLO engine (the same burn rates and breach ticks over one tick sequence,
the same parse errors), the ``top`` dashboard (scrape and tail mode, the
same text), and the training engine acting on ``telemetry.metrics_port``,
``.sampler`` and ``.slo``. The HTTP cases bind 127.0.0.1:0 with socket
timeouts; no case waits on the sampler's wall-clock cadence."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.monitor import events as jax_events
from deepspeed_tpu.monitor import exporter as jax_exporter
from deepspeed_tpu.monitor import slo as jax_slo
from deepspeed_tpu.monitor import top as jax_top
from deepspeed_tpu.monitor.config import get_telemetry_config as jax_telemetry_config
from deepspeed_tpu.monitor.events import FlightRecorder as JaxRecorder
from deepspeed_tpu.monitor.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu.monitor.sampler import MetricsSampler as JaxSampler
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor import events as port_events
from deepspeed_tpu_torch.monitor import exporter, slo, top
from deepspeed_tpu_torch.monitor.config import get_telemetry_config
from deepspeed_tpu_torch.monitor.events import FlightRecorder
from deepspeed_tpu_torch.monitor.health import multilabel_series
from deepspeed_tpu_torch.monitor.metrics import (MetricsRegistry, get_registry,
                                                 parse_prometheus_text, validate_snapshot)
from deepspeed_tpu_torch.monitor.sampler import MetricsSampler, sampler_from_config

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TIMEOUT = 10


def _fill(reg):
    """The same series in either package's registry."""
    reg.counter("serving/requests", "total").inc(4)
    h = reg.histogram("serving/ttft_ms", "ttft")
    for i, v in enumerate((3.0, 12.0, 80.0, 700.0)):
        h.observe(v, exemplar={"rid": str(i)})
    reg.gauge("train/mfu", "mfu").set(0.42)
    ph = reg.histogram("serving/phase_ms", "phases", labelnames=("phase", "replica"))
    ph.labels(phase="decode", replica="r0").observe(4.5, exemplar={"rid": "7"})
    reg.counter("health/anomalies", "firings", labelnames=("type",)).labels(type="nonfinite")
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_text_matches_the_jax_package(openmetrics, monkeypatch):
    # each package's process-global recorder fresh and off, so the recorder
    # loss gauges a render refreshes read the same whatever ran before
    monkeypatch.setattr(port_events, "_recorder", FlightRecorder())
    monkeypatch.setattr(jax_events, "_recorder", JaxRecorder())
    got, ctype = exporter.render_exposition(_fill(MetricsRegistry()), openmetrics=openmetrics)
    want, jtype = jax_exporter.render_exposition(_fill(JaxRegistry()), openmetrics=openmetrics)
    assert (got, ctype) == (want, jtype)
    assert got.endswith("# EOF\n") == openmetrics
    assert ("# {rid=" in got) == openmetrics
    snap = parse_prometheus_text(got)
    assert snap["counters"]["serving_requests"] == 4


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode()


def test_exporter_serves_metrics_healthz_and_stops():
    reg = _fill(MetricsRegistry())
    with exporter.MetricsExporter(reg, port=0) as ex:
        host, port = ex.address
        assert host == "127.0.0.1" and port > 0
        status, ctype, text = _get(ex.url)
        assert status == 200 and ctype == exporter.PROM_CONTENT_TYPE
        assert text == exporter.render_exposition(reg)[0]
        _, ctype, text = _get(ex.url, accept="application/openmetrics-text; version=1.0.0")
        assert ctype == exporter.OPENMETRICS_CONTENT_TYPE and text.endswith("# EOF\n")
        status, _, body = _get(f"http://{host}:{port}/healthz")
        assert status == 200 and json.loads(body) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://{host}:{port}/nope")
        assert e.value.code == 404
        assert ex.start() == (host, port)            # idempotent
        url = ex.url
    with pytest.raises(OSError):
        _get(url)


def test_sampler_ticks_ring_jsonl_and_rotation(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serving/requests").inc(2)
    path = str(tmp_path / "s.jsonl")
    s = MetricsSampler(reg, interval_s=0.05, path=path, ring=3)
    for _ in range(5):
        s.tick()
    assert s.seq == 5 and len(s.ring) == 3 and s.ring[-1]["seq"] == 5
    recs = [json.loads(line) for line in open(path)]
    assert [r["seq"] for r in recs] == [1, 2, 3, 4, 5]
    for r in recs:
        validate_snapshot(r)
        assert r["counters"]["serving/requests"] == 2
    fat = MetricsRegistry()
    for i in range(40):
        fat.counter(f"t/c{i}").inc()
    rot = str(tmp_path / "r.jsonl")
    s = MetricsSampler(fat, interval_s=1, path=rot, max_bytes=2048, keep=2)
    for _ in range(30):
        s.tick()
    assert os.path.getsize(rot) <= 2048 and os.path.exists(rot + ".1")
    assert not os.path.exists(rot + ".3")
    seqs = [json.loads(line)["seq"] for line in open(rot)]
    assert seqs == sorted(seqs) and seqs[-1] == 30
    with pytest.raises(ValueError, match="interval_s"):
        MetricsSampler(reg, interval_s=0)
    s = MetricsSampler(reg, interval_s=3600.0)      # the thread never ticks by itself
    s.start()
    assert s.start() is s
    s.stop()
    assert s.seq == 1 and s._thread is None         # stop() takes one last snapshot


@pytest.mark.parametrize("section", [
    {"sampler": True}, True,
    {"slo": {"enabled": True, "objectives": [{"metric": "serving/ttft_ms",
                                              "threshold_ms": 50}]}},
    {"slo": {"enabled": True}},
    {"sampler": {"enabled": True, "interval_s": 0.5, "keep": 3, "ring": 7}},
], ids=repr)
def test_sampler_from_config_matches_the_jax_package(section):
    from deepspeed_tpu.monitor.sampler import sampler_from_config as jax_from_config
    got = sampler_from_config(get_telemetry_config({"telemetry": section}), MetricsRegistry())
    want = jax_from_config(jax_telemetry_config({"telemetry": section}), JaxRegistry())
    assert (got is None) == (want is None)
    if got is not None:
        for k in ("interval_s", "path", "max_bytes", "keep"):
            assert getattr(got, k) == getattr(want, k), k
        assert got.ring.maxlen == want.ring.maxlen
        assert (got.slo is None) == (want.slo is None)
        if got.slo is not None:
            assert [o.__dict__ for o in got.slo.objectives] == \
                [o.__dict__ for o in want.slo.objectives]


@pytest.mark.parametrize("bad,match", [
    ([{"name": "x"}], "missing 'metric'"),
    ([{"metric": "m", "kind": "vibes"}], "kind"),
    ([{"metric": "m", "kind": "latency"}], "threshold_ms"),
    ([{"metric": "m", "kind": "ratio"}], "total_metric"),
    ([{"metric": "m", "threshold_ms": 1, "surprise": 2}], "unknown keys"),
    ([{"metric": "m", "threshold_ms": 1}, {"metric": "m", "threshold_ms": 2}], "duplicate"),
    ([{"metric": "m", "threshold_ms": 1, "objective": 1.5}], "outside"),
    ([{"metric": "m", "threshold_ms": 1, "windows": [0]}], "windows"),
])
def test_objective_parse_errors_match_the_jax_package(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        slo.parse_objectives(bad)
    with pytest.raises(ValueError) as want:
        jax_slo.parse_objectives(bad)
    assert str(got.value) == str(want.value)


# (tick, ttft observations in ms, rejected, submitted): healthy ticks, a
# sustained TTFT burn, a rejection burst, then recovery
TRACE = ([(t, [10.0] * 4, 0, 10) for t in range(5)]
         + [(t, [200.0] * 5, 0, 10) for t in range(5, 20)]
         + [(t, [30.0, 60.0], 6, 10) for t in range(20, 26)]
         + [(t, [5.0], 0, 10) for t in range(26, 34)])


def _slo_replay(reg, rec, engine_cls, sampler_cls, parse, path=None):
    objectives = parse(
        [{"name": "ttft_p99", "metric": "serving/ttft_ms", "kind": "latency",
          "threshold_ms": 50.0, "objective": 0.99, "windows": [8, 2]},
         {"name": "errors", "metric": "serving/rejected_requests", "kind": "ratio",
          "total_metric": "serving/requests", "objective": 0.9, "windows": [4, 2]}])
    engine = engine_cls(objectives, registry=reg, events=rec)
    sampler = sampler_cls(reg, interval_s=1.0, path=path, slo=engine)
    h = reg.histogram("serving/ttft_ms", "ttft")
    bad, total = reg.counter("serving/rejected_requests"), reg.counter("serving/requests")
    fired, burns = [], []
    for tick, obs, rejected, submitted in TRACE:
        for v in obs:
            h.observe(v)
        bad.inc(rejected)
        total.inc(submitted)
        r = sampler.tick()
        fired += [(b["objective"], b["tick"], b["burn_rate"]) for b in r.get("slo_breaches", [])]
        burns.append(sorted((tuple(sorted(lab.items())), v) for lab, v in
                            multilabel_series(r["gauges"], "slo/burn_rate")))
    return fired, burns


def test_slo_engine_gives_the_jax_burn_rates_and_breach_ticks(tmp_path, capsys):
    path = str(tmp_path / "samples.jsonl")
    rec = FlightRecorder(enabled=True)
    fired, burns = _slo_replay(MetricsRegistry(), rec, slo.SloEngine, MetricsSampler,
                               slo.parse_objectives, path)
    jfired, jburns = _slo_replay(JaxRegistry(), JaxRecorder(enabled=True), jax_slo.SloEngine,
                                 JaxSampler, jax_slo.parse_objectives)
    assert fired == jfired and burns == jburns
    assert [t for o, t, _ in fired if o == "ttft_p99"] == [9, 17, 25]
    assert any(o == "errors" for o, _, _ in fired)
    breaches = [e for e in rec.snapshot() if e.kind == "slo.breach"]
    assert [(e.data["objective"], e.data["tick"]) for e in breaches] == \
        [(o, t) for o, t, _ in fired]
    # the sampler's JSONL through top, as the JAX package renders it
    for argv in ([path, "--once"], [path, "--json"]):
        assert top.top_cli(argv) == 0
        got = capsys.readouterr().out
        assert jax_top.top_cli(argv) == 0
        assert got == capsys.readouterr().out
    assert "BREACH" in got or "breaches" in got
    assert slo.serving_objectives(500, 50, 0.01) == jax_slo.serving_objectives(500, 50, 0.01)


def test_top_scrape_mode_and_missing_source(tmp_path, capsys):
    reg = _fill(MetricsRegistry())
    text = exporter.render_exposition(reg)[0]
    got, want = top.snapshot_from_prometheus(text), jax_top.snapshot_from_prometheus(text)
    got.pop("ts"), want.pop("ts")
    assert got == want and "serving/ttft_ms" in got["histograms"]
    with exporter.MetricsExporter(reg) as ex:
        rec, prev = top.fetch_snapshots(ex.url, timeout=TIMEOUT)
        assert prev is None and rec["counters"]["serving/requests"] == 4
        assert top.top_cli([ex.url, "--once"]) == 0
        assert "TTFT" in capsys.readouterr().out
    missing = str(tmp_path / "none.jsonl")
    assert top.top_cli([missing, "--once"]) == 1
    assert "no data" in capsys.readouterr().out
    assert top.top_cli([missing, "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["error"] == "no data"


MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=32)


def test_training_engine_acts_on_the_exposition_plane(tmp_path):
    """telemetry.metrics_port 0, a sampler path and an SLO over the train
    step time: /metrics between steps parses back to the registry's train/
    values, the sampler's ticks land in its JSONL with the SLO gauges,
    destroy() stops both (refused connections, one last snapshot). The
    registry is process-global: a file that ran a training engine with
    telemetry on the same worker before this one left its train/ series
    there, so the case starts from an emptied registry."""
    get_registry().reset()
    path = str(tmp_path / "samples.jsonl")
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 4,
              "telemetry": {"metrics_port": 0,
                            "sampler": {"enabled": True, "path": path, "interval_s": 3600},
                            "slo": {"enabled": True, "objectives": [
                                {"name": "step", "metric": "train/step_time_ms",
                                 "threshold_ms": 1e6, "windows": [2, 1]}]}}}
    model = CausalLM(TransformerConfig(**MODEL))
    eng = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")[0]
    try:
        assert eng._tel_exporter is not None and eng._tel_sampler.slo is not None
        ids = np.random.default_rng(0).integers(0, 64, size=(4, 16))
        for _ in range(2):
            eng.train_batch({"input_ids": ids})
            eng._tel_sampler.tick()
        _, _, text = _get(eng._tel_exporter.url)
        scraped = top.snapshot_from_prometheus(text)
        snap = get_registry().snapshot()
        for k, v in snap["gauges"].items():
            if k.startswith("train/"):
                assert scraped["gauges"][k] == pytest.approx(v, rel=1e-9), k
        assert scraped["counters"]["train/steps"] == snap["counters"]["train/steps"] == 2
        url = eng._tel_exporter.url
    finally:
        eng.destroy()
    with pytest.raises(OSError):
        _get(url)
    recs = [json.loads(line) for line in open(path)]
    assert [r["seq"] for r in recs] == [1, 2, 3]            # two ticks + the final one
    assert 'slo/burn_rate{objective="step",window="2"}' in recs[-1]["gauges"]
    get_registry().reset()
