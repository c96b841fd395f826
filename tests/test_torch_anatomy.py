"""Request latency anatomy in the port (``deepspeed_tpu_torch/monitor/
anatomy.py``) against the JAX package's: over the flight-recorder events
of a port serve (exported as ``events.jsonl`` and read back) and over a
hand-built fleet trace with a handoff and a replay, ``request_anatomy``,
``trace_anatomy`` and their rendered text must be the JAX package's, and
each request's phases must sum to its end-to-end time exactly (in ns)."""

import json

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.monitor import anatomy as ja
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor import anatomy as pa
from deepspeed_tpu_torch.monitor.events import get_flight_recorder
from deepspeed_tpu_torch.monitor.metrics import get_registry

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=256)


def _ns(ms):
    return round(ms * 1e6)


def _sums_exactly(a):
    return sum(_ns(v) for v in a["phases_ms"].values()) == _ns(a["total_ms"])


@pytest.fixture(scope="module")
def served_events(tmp_path_factory):
    """The events of a port serve with telemetry events on (prefix caching,
    a preemption under a small pool, speculation off), through JSONL."""
    get_registry().reset()
    rec = get_flight_recorder()
    rec.clear()
    model = CausalLM(TransformerConfig(**MODEL))
    eng = deepspeed_tpu_torch.init_inference(
        model, dtype="fp32", device="cpu", telemetry={"events": True},
        serving={"block_size": 16, "max_running": 2, "max_num_blocks": 10})
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 64, size=n) for n in (40, 9, 70, 33)]
    eng.generate_batch(prompts, max_new_tokens=12)
    path = rec.write_jsonl(str(tmp_path_factory.mktemp("anatomy") / "events.jsonl"))
    rec.disable()
    rec.clear()
    get_registry().reset()
    with open(path) as f:
        return path, [json.loads(line) for line in f if line.strip()]


def test_request_anatomy_matches_the_jax_package(served_events):
    _, events = served_events
    rids = sorted({e["rid"] for e in events if e.get("kind") == "req.enqueue"})
    assert len(rids) == 4
    for rid in rids + [999]:
        got, want = pa.request_anatomy(events, rid), ja.request_anatomy(events, rid)
        assert got == want, rid
        if got is None:
            continue
        assert _sums_exactly(got) and got["outcome"] == "retire"
        assert got["phases_ms"]["prefill"] > 0 and got["phases_ms"]["decode"] > 0
        assert pa.format_anatomy(got) == ja.format_anatomy(want)
        assert pa.request_anatomy(events, rid, replica="r0") == got
    assert pa.PHASES == ja.PHASES


def _fleet_events():
    """A prefill replica's leg, the router's handoff, the decode replica's
    leg and a failover replay, as flattened JSONL dicts (ts in ns)."""
    ev = []

    def add(ts, kind, rid=None, dur=0, **data):
        ev.append({"ts_ns": ts, "kind": kind, "rid": rid, "dur_ns": dur, **data})

    add(0, "req.submit", 1, replica="r0")
    add(50, "req.enqueue", 1, trace="t7", parent=None, replica="r0")
    add(400, "req.admit", 1, replica="r0")
    add(500, "req.prefill", 1, dur=3000, replica="r0")
    add(3600, "req.retire", 1, generated=1, replica="r0")
    add(3700, "serve.handoff", 1, trace="t7", from_replica="r0", to_replica="r1")
    add(3800, "req.submit", 1, replica="r1")
    add(3900, "req.enqueue", 1, trace="t7", parent=1, replica="r1")
    add(4000, "req.phase", 1, dur=80, phase="queue", replica="r1")
    add(4100, "kv.fetch", 1, dur=500, replica="r1")
    for i in range(4):
        add(4700 + 300 * i, "decode.tick", dur=250, rids=[1, 2], replica="r1")
    add(4800, "req.spec_verify", 1, dur=120, replica="r1")
    add(6000, "req.retire", 1, generated=5, replica="r1")
    add(6100, "req.enqueue", 2, trace="t7", parent=1, replica="r1")
    add(7000, "req.timeout", 2, replica="r1")
    return ev


def test_trace_anatomy_matches_the_jax_package():
    events = _fleet_events()
    got, want = pa.trace_anatomy(events, "t7"), ja.trace_anatomy(events, "t7")
    assert got == want and len(got["legs"]) == 3 and got["handoffs"]
    assert all(_sums_exactly(leg) for leg in got["legs"])
    assert pa.format_trace_anatomy(got) == ja.format_trace_anatomy(want)
    assert pa.trace_anatomy(events, "t9") is None
    for rep in ("r0", "r1", None):
        assert pa.request_anatomy(events, 1, replica=rep) == \
            ja.request_anatomy(events, 1, replica=rep)
    assert pa.resolve_request_id("t7") == ja.resolve_request_id("t7") == ("t7", None)
    assert pa.resolve_request_id("12") == (None, 12)
