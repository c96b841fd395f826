"""The port's adaptive-controller core (``deepspeed_tpu_torch/monitor/
controller.py``) against the JAX package's: the knob ladders and the knob
set of a serving config, ``DecisionCore`` over one observation trace (the
same actions), the live wrapper over the same burn-gauge scenario (the same
decision ledger, applied through a caller-supplied ``apply_fn``), and
``replay_decisions`` / ``explain_decisions`` over the port's ledger and
over an ``events.jsonl`` the JAX package wrote, with the ``ctl`` CLI."""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.policy import FifoPolicy as JaxFifo
from deepspeed_tpu.monitor import controller as jc
from deepspeed_tpu.monitor.events import FlightRecorder as JaxRecorder
from deepspeed_tpu.monitor.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.inference.config import ServingConfig
from deepspeed_tpu_torch.inference.policy import FifoPolicy
from deepspeed_tpu_torch.monitor import controller as pc
from deepspeed_tpu_torch.monitor.config import CtlConfig
from deepspeed_tpu_torch.monitor.events import FlightRecorder
from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def test_ladders_match_the_jax_package():
    for v in range(0, 2200, 64):
        assert pc._chunk_ladder(v) == jc._chunk_ladder(v), v
    for k in range(0, 17):
        assert pc._spec_ladder(k) == jc._spec_ladder(k), k


@pytest.mark.parametrize("serving,queue,pinned", [
    ({"prefill_chunk_tokens": 256, "speculative": {"mode": "ngram", "k": 2}}, 4, ()),
    ({"prefill_chunk_tokens": 256, "speculative": {"mode": "ngram", "k": 2}}, 4,
     ("spec_k", "max_queue")),
    ({}, 0, ()),
    ({"prefill_chunk_tokens": 1024, "fault": {"shed_queue_depth": 12}}, 1, ()),
    ({"kv_host": {"enabled": True, "spill": "off"}}, 9, ("shed_depth",)),
], ids=repr)
def test_knobs_from_serving_match_the_jax_package(serving, queue, pinned):
    got = pc.knobs_from_serving(ServingConfig(**serving), policy=FifoPolicy(
        admission_max_queue=queue), pinned=pinned)
    want = jc.knobs_from_serving(JaxServingConfig(**serving), policy=JaxFifo(
        admission_max_queue=queue), pinned=pinned)
    assert [(k.name, k.ladder) for k in got] == [(k.name, k.ladder) for k in want]


def _knobs(mod):
    return [mod.KnobSpec("prefill_chunk", (512, 256, 128)), mod.KnobSpec("spec_k", (4, 3, 1, 0)),
            mod.KnobSpec("max_queue", (0, 16, 8, 4)), mod.KnobSpec("min_free_blocks", (0, 2, 4)),
            mod.KnobSpec("shed_depth", (0, 16, 8)), mod.KnobSpec("kv_spill", (0, 1))]


def _trace(seed=0, n=120):
    """A seeded observation trace through every regime: bursts of each
    burn class, the dead band, KV pressure with and without a host tier,
    spec acceptance around its floor, and long headroom."""
    r = np.random.default_rng(seed)
    out = []
    for t in range(1, n + 1):
        phase = (t // 15) % 4 if t <= n - 40 else 3      # a long quiet tail
        if phase == 3:
            out.append(dict(tick=t, kv_util=0.2, spec_acceptance=1.0))
            continue
        burn = lambda: float(r.choice([0.0, 0.1, 0.5, 1.5, 3.0]))
        out.append(dict(tick=t, ttft_burn=burn() if phase in (0, 2) else 0.0,
                        tpot_burn=burn() if phase == 1 else 0.0,
                        goodput_burn=burn() if phase == 2 else 0.0,
                        kv_util=float(r.uniform(0.5, 1.0)), host_tier_ok=bool(r.integers(2)),
                        spec_acceptance=float(r.uniform(0.0, 1.0)),
                        queue_depth=float(r.integers(0, 20))))
    return out


@pytest.mark.parametrize("params", [{}, {"cooldown_ticks": 1, "relax_after": 3},
                                    {"tighten_threshold": 2.0, "relax_threshold": 0.05,
                                     "spec_accept_floor": 0.8, "kv_util_high": 0.95}],
                         ids=repr)
def test_decision_core_gives_the_jax_actions(params):
    core, jcore = pc.DecisionCore(_knobs(pc), **params), jc.DecisionCore(_knobs(jc), **params)
    got, want = [], []
    for obs in _trace():
        got += [a.to_payload() for a in core.decide(pc.Observation(**obs))]
        want += [a.to_payload() for a in jcore.decide(jc.Observation(**obs))]
    assert got == want and {a["direction"] for a in got} == {"tighten", "relax"}
    assert core.values() == jcore.values() and core.manifest() == jcore.manifest()
    again = pc.DecisionCore.from_manifest(core.manifest())
    assert again.params() == core.params()


def _scenario(mod, registry, recorder, applied, n_ticks=30):
    """The live wrapper over burn gauges set tick by tick (the stand-in for
    a live SLO engine): tighten, the dead band, then headroom."""
    ctl = mod.AdaptiveController(_knobs(mod)[:5], registry=registry, events=recorder,
                                 apply_fn=applied.append, cooldown_ticks=2, relax_after=3)
    g = registry.gauge("slo/burn_rate", "burn", labelnames=("objective", "window"))
    for t in range(n_ticks):
        value = 2.0 if t < 8 else (0.6 if t < 12 else 0.0)
        for obj in ("ttft_p99", "tpot_p99", "goodput"):
            for w in ("8", "2"):
                g.labels(objective=obj, window=w).set(0.0 if obj == "tpot_p99" and t < 8
                                                      else value)
        registry.gauge("serving/queue_depth").set(t % 5)
        registry.counter("serving/wasted_tokens", labelnames=("cause", "replica")).labels(
            cause="preempt", replica="r0").inc(t)
        ctl.tick()
    return ctl


def test_live_controller_ledger_matches_the_jax_package(tmp_path, capsys):
    applied, japplied = [], []
    rec, jrec = FlightRecorder(4096, enabled=True), JaxRecorder(4096, enabled=True)
    ctl = _scenario(pc, MetricsRegistry(), rec, applied)
    jctl = _scenario(jc, JaxRegistry(), jrec, japplied)
    events = [e.to_dict() for e in rec.snapshot()]
    jevents = [e.to_dict() for e in jrec.snapshot()]
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts_ns"} for e in evs]
    assert strip(events) == strip(jevents)
    recorded = pc.recorded_decisions(events)
    assert recorded == jc.recorded_decisions(jevents)
    assert {a["direction"] for a in recorded} == {"tighten", "relax"}
    assert [a.to_payload() for batch in applied for a in batch] == recorded
    assert len(applied) == len(japplied) and ctl.values() == jctl.values()
    assert pc.replay_decisions(events) == recorded
    snap = ctl.registry.snapshot()
    assert snap["gauges"]['ctl/knob{name="max_queue"}'] == ctl.values()["max_queue"]
    # a ledger the JAX package wrote: replay, recorded, explain, the CLI
    jpath = jrec.write_jsonl(str(tmp_path / "jax_events.jsonl"))
    assert pc.replay_decisions(jpath) == jc.replay_decisions(jpath) == recorded
    assert pc.recorded_decisions(jpath) == recorded
    assert pc.explain_decisions(jpath) == jc.explain_decisions(jpath)
    assert any("ttft=2.00" in line and "tighten" in line for line in pc.explain_decisions(jpath))
    assert cli.main(["ctl", "replay", jpath]) == 0
    assert "replay OK" in capsys.readouterr().out
    assert cli.main(["ctl", "explain", jpath]) == 0
    assert capsys.readouterr().out.splitlines() == pc.explain_decisions(jpath)
    # the port's own ledger file, and a tampered one that must diverge
    path = rec.write_jsonl(str(tmp_path / "events.jsonl"))
    assert cli.main(["ctl", "replay", path, "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[0]) == recorded and out[1].startswith("replay OK")
    lines = [json.loads(line) for line in open(path)]
    for e in lines:
        if e.get("kind") == "ctl.decide":
            e["value"] = 999
            break
    bad = tmp_path / "tampered.jsonl"
    bad.write_text("".join(json.dumps(e) + "\n" for e in lines))
    assert cli.main(["ctl", "replay", str(bad)]) == 1
    assert "DIVERGED" in capsys.readouterr().out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert cli.main(["ctl", "explain", str(empty)]) == 1
    with pytest.raises(ValueError, match="manifest"):
        pc.replay_decisions([{"kind": "ctl.observe", "tick": 1}])


def test_controller_from_config_matches_the_jax_package():
    from deepspeed_tpu.monitor.config import CtlConfig as JaxCtlConfig
    kw = {"enabled": True, "cooldown_ticks": 3, "knobs": {"spec_k": "off"}}
    serving = {"prefill_chunk_tokens": 512, "speculative": {"mode": "ngram", "k": 4}}
    got = pc.controller_from_config(CtlConfig(**kw), ServingConfig(**serving),
                                    registry=MetricsRegistry())
    want = jc.controller_from_config(JaxCtlConfig(**kw), JaxServingConfig(**serving),
                                     registry=JaxRegistry())
    assert got.core.manifest() == want.core.manifest()
    assert "spec_k" not in got.values()
    assert pc.controller_from_config(CtlConfig(), ServingConfig()) is None
