"""The port's health observatory (``deepspeed_tpu_torch/monitor/health.py``
and the training engine's sentinels) against the JAX package's: the
sentinel vector over the same numpy grads and params (bucket names equal,
non-finite counts exact, norms within SENTINEL_TOL relative), the engine's
per-step health records over 3 steps with health on (each field within
ENGINE_TOL relative), the seven detectors over one ``StepHealth`` sequence
(the same firings at the same steps, the same debug-bundle files), the
summary dict, the screen's text and the ``health`` CLI's output (identical),
the host syncs of a health-on step, and the checkpoint-failure feed."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.monitor import health as jax_health
from deepspeed_tpu.monitor.config import HealthConfig as JaxHealthConfig
from deepspeed_tpu.monitor.metrics import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor import health
from deepspeed_tpu_torch.monitor.config import HealthConfig
from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry, get_registry
from deepspeed_tpu_torch.runtime import engine as port_engine
from tests.test_torch_training import LLAMA, _batches, _config, _jax_params, one_device_mesh  # noqa: F401,E501

SENTINEL_TOL = 1e-6    # relative, the vector's norms over the same numpy inputs
ENGINE_TOL = 1e-5      # relative, each health record field after the same steps
# the update norm (and the update / param ratio): the port takes it from
# new - old of each fp32 leaf, the JAX package from lr ||u||; a leaf near
# 1.0 (the norm scales) keeps its update to ~ulp(1) / |update| of itself
UPDATE_TOL = 1e-3


def _port_tree(tree):
    return dict(params_from_jax(TransformerConfig(**LLAMA), tree).named_parameters())


def _sentinels_both(grads, new, delta, max_buckets):
    """The JAX package's sentinel vector and the engine's (``_Sentinels``
    fed the port's per-layer leaves), with the update norm ``||delta||``."""
    upd_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(d)) for d in jax.tree.leaves(delta))))
    assignment, names = jax_health.make_bucket_assignment(grads, max_buckets)
    want = np.asarray(jax_health.compute_sentinels(grads, new, upd_norm, None, assignment,
                                                   names))
    g, p, dl = _port_tree(grads), _port_tree(new), _port_tree(delta)
    order = list(g)
    p_assign, p_names = health.make_bucket_assignment(order, max_buckets)
    assert p_names == names
    sen = port_engine._Sentinels(p_assign, p_names, None)
    norm = port_engine.norm_of_norms([sen.grad_leaf(g[n]) for n in order])
    for n in order:
        sen.updated(p[n] + dl[n], p[n])
    got = sen.vector(norm).numpy()
    assert got.shape == want.shape == (len(health.SENTINEL_FIELDS) + len(names),)
    return got, want, names


@pytest.mark.parametrize("max_buckets", [8, 2])
def test_sentinel_vector_matches_the_jax_package(max_buckets):
    copy = lambda t: jax.tree.map(np.array, t)
    grads = jax.tree.map(lambda a: a * 0.1, _jax_params(LLAMA, seed=1)[1])
    new = copy(_jax_params(LLAMA, seed=2)[1])
    delta = jax.tree.map(lambda a: a * 1e-3, _jax_params(LLAMA, seed=3)[1])
    got, want, names = _sentinels_both(grads, new, delta, max_buckets)
    assert got[0] == want[0] == 0 and got[1] == want[1] == 0
    upd = [health.SENTINEL_FIELDS.index(f) for f in ("update_norm", "update_ratio")]
    rest = [i for i in range(2, got.size) if i not in upd]
    np.testing.assert_allclose(got[rest], want[rest], rtol=SENTINEL_TOL, atol=0)
    np.testing.assert_allclose(got[upd], want[upd], rtol=UPDATE_TOL, atol=0)

    grads["layers"]["attn"]["wq"][1, 3, 5] = np.nan       # layer 1 of a stacked leaf
    grads["lm_head"][0, 0] = np.inf
    new["ln_f"]["scale"][2] = -np.inf
    got, want, names = _sentinels_both(grads, new, delta, max_buckets)
    assert got[0] == want[0] == 2 and got[1] == want[1] == 1      # counts exact
    assert all(not math.isfinite(x) for x in (got[2], want[2], got[3], want[3]))
    d_got, d_want = health.sentinel_to_dict(got, names), jax_health.sentinel_to_dict(want, names)
    assert list(d_got["bucket_norms"]) == list(d_want["bucket_norms"])
    for b in names:
        a, w = d_got["bucket_norms"][b], d_want["bucket_norms"][b]
        if math.isfinite(w):
            assert abs(a - w) <= SENTINEL_TOL * w, b
        else:
            assert not math.isfinite(a) and (math.isnan(a) == math.isnan(w)), b
    # the port takes the update norm from new - old: an inf param reads nan
    # there, where the JAX package's update vector stays finite
    assert math.isnan(got[4]) and math.isfinite(want[4])


def test_bucket_assignment_groups_port_leaves_into_the_jax_leaves():
    names = ["layers.1.attn.wq", "embed.tokens", "layers.0.attn.wq", "ln_f.scale", "lm_head"]
    assignment, buckets = health.make_bucket_assignment(names, 8)
    assert buckets == ("embed", "layers", "lm_head", "ln_f")
    assert assignment == (1, 0, 1, 3, 2)
    assert health.make_bucket_assignment(names, 3) == ((1, 0, 1, 2, 2),
                                                       ("embed", "layers", "other"))


HEALTH_CFG = {"enabled": True, "window": 4, "warmup_steps": 2}


LAMB = {"type": "Lamb", "params": {"lr": 3e-4, "weight_decay": 0.01}}


@pytest.mark.parametrize("gas,optimizer", [(2, None), (1, None), (2, LAMB)],
                         ids=["fusedadam-gas2", "fusedadam-gas1", "lamb-gas2"])
def test_engine_health_records_match_the_jax_engine(one_device_mesh, gas, optimizer):  # noqa: F811,E501
    """Health on, 3 steps of the training test's config (FusedAdam, or Lamb
    with its per-group scratch, WarmupLR, clipping) in both engines: every
    field of each step's health record."""
    config = _config(gas=gas, micro=2 if gas == 2 else 4,
                     telemetry={"health": HEALTH_CFG},
                     **({"optimizer": optimizer} if optimizer else {}))
    jmodel, jparams = _jax_params(LLAMA, seed=3)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=one_device_mesh)
    model = CausalLM(TransformerConfig(**LLAMA))
    peng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(model.config, jparams), config=config,
        device="cpu")
    try:
        for batch in _batches(31, 3, 4):
            jeng.train_batch(batch)
            peng.train_batch(batch)
        assert peng._health.bucket_names == jeng._health.bucket_names
        assert len(peng._health.ring) == len(jeng._health.ring) == 3
        for a, b in zip(peng._health.ring, jeng._health.ring):
            assert a.step == b.step and a.skipped == b.skipped
            assert a.nonfinite_grads == b.nonfinite_grads == 0
            assert a.nonfinite_params == b.nonfinite_params == 0
            for f, tol in (("loss", ENGINE_TOL), ("grad_norm", ENGINE_TOL),
                           ("update_ratio", UPDATE_TOL)):
                x, y = getattr(a, f), getattr(b, f)
                assert abs(x - y) <= tol * abs(y), (a.step, f, x, y)
            np.testing.assert_allclose(a.bucket_norms, b.bucket_norms, rtol=ENGINE_TOL)
        assert peng._health.ring[0].update_ratio == 0.0     # WarmupLR's step-0 lr is 0
        assert peng.health_report()["anomalies"] == jeng.health_report()["anomalies"]
    finally:
        peng.destroy()
        get_registry().reset()


def test_client_optimizer_sentinels_take_the_update_from_new_minus_old():
    """With a client optimizer the update norm comes from a copy of every
    master kept across ``step()``: it equals ``||new - old||`` of the step,
    recomputed here in fp64, and the bucket norms the grads' fp64 norms."""
    import torch as _torch
    _, jparams = _jax_params(LLAMA, seed=3)
    model = CausalLM(TransformerConfig(**LLAMA))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(model.config, jparams),
        optimizer=lambda ps: _torch.optim.AdamW(ps, lr=1e-3),
        config=_config(telemetry={"health": HEALTH_CFG}, scheduler=None), device="cpu")
    try:
        batches = _batches(34, 2, 4)
        eng.train_batch(batches[0])
        before = {n: p.detach().double().clone() for n, p in eng.state.params.named_parameters()}
        eng.train_batch(batches[1])
        d = health.sentinel_to_dict(eng._sentinels.tolist(), eng._health.bucket_names)
        plain = math.sqrt(sum(float(((p.detach().double() - before[n]) ** 2).sum())
                              for n, p in eng.state.params.named_parameters()))
        assert abs(d["update_norm"] - plain) <= UPDATE_TOL * plain and plain > 0
        assert eng._health.ring[-1].update_ratio == pytest.approx(d["update_ratio"])
        assert d["nonfinite_grads"] == d["nonfinite_params"] == 0
    finally:
        eng.destroy()
        get_registry().reset()


def test_health_on_costs_one_sync_a_step_and_changes_no_loss():
    import deepspeed_tpu_torch.accelerator.abstract_accelerator as accel
    _, jparams = _jax_params(LLAMA, seed=3)
    runs = {}
    for name, tel in (("off", None), ("telemetry", {"enabled": True}),
                      ("health", {"health": HEALTH_CFG}),
                      ("no_sentinels", {"health": {**HEALTH_CFG, "sentinels": False}})):
        model = CausalLM(TransformerConfig(**LLAMA))
        config = _config(**({"telemetry": tel} if tel else {}))
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=params_from_jax(model.config, jparams),
            config=config, device="cpu")
        losses, syncs = [], []
        for batch in _batches(32, 3, 4):
            s0 = accel.syncs
            losses.append(eng.train_batch(batch))
            syncs.append(accel.syncs - s0)
        runs[name] = ([float(x) for x in losses], syncs)
        eng.destroy()
        get_registry().reset()
    assert runs["off"][1] == [0, 0, 0]
    for name in ("telemetry", "health", "no_sentinels"):
        assert runs[name][1] == [1, 1, 1], name
        assert runs[name][0] == runs["off"][0], name


def _records():
    """One StepHealth sequence that fires every step detector: a loss
    spike, a grad-norm explosion, non-finite numerics, sustained fp16
    skips, a data stall and a plateau."""
    recs = []
    for i in range(40):
        loss = 2.0 - 0.01 * min(i, 10)
        rec = dict(step=i, loss=loss, grad_norm=1.0 + 0.01 * (i % 3), loss_scale=2.0 ** 10,
                   step_time_s=0.1, wait_time_s=0.01, bucket_norms=(0.5, 0.5))
        if i == 12:
            rec["loss"] = 9.0
        if i == 14:
            rec["grad_norm"] = 80.0
        if i == 16:
            rec["nonfinite_grads"] = 3.0
        if i == 17:
            rec["nonfinite_params"] = 1.0
        if i == 18:
            rec["grad_norm"] = float("nan")
        if 20 <= i < 26:
            rec["skipped"] = True
        if 27 <= i < 33:
            rec["wait_time_s"] = 0.5
        recs.append(rec)
    return recs


DETECT_CFG = {"enabled": True, "action": "record", "warmup_steps": 3, "window": 5,
              "plateau_steps": 6, "overflow_window": 3, "data_stall_steps": 3,
              "ckpt_failure_consecutive": 2}


@pytest.mark.parametrize("action", ["record", "dump"])
def test_detectors_fire_at_the_same_steps(tmp_path, action, monkeypatch):
    from deepspeed_tpu.monitor import events as jax_events
    from deepspeed_tpu_torch.monitor import events as port_events
    # each package's process-global recorder fresh and off: a bundle then
    # holds no events.jsonl on either side, whatever ran before
    monkeypatch.setattr(port_events, "_recorder", port_events.FlightRecorder())
    monkeypatch.setattr(jax_events, "_recorder", jax_events.FlightRecorder())
    cfg = {**DETECT_CFG, "action": action}
    jm = jax_health.HealthMonitor(JaxHealthConfig(**cfg, dump_dir=str(tmp_path / "jax")),
                                  registry=JaxRegistry(), bucket_names=("a", "b"))
    pm = health.HealthMonitor(HealthConfig(**cfg, dump_dir=str(tmp_path / "port")),
                              registry=MetricsRegistry(), bucket_names=("a", "b"))
    fired_j, fired_p = [], []
    for r in _records():
        fired_j.append(jm.observe_step(jax_health.StepHealth(**r)))
        fired_p.append(pm.observe_step(health.StepHealth(**r)))
        if r["step"] in (5, 6, 7, 9):
            ok = r["step"] == 9
            fired_j.append(jm.observe_checkpoint(ok, step=r["step"]))
            fired_p.append(pm.observe_checkpoint(ok, step=r["step"]))
    assert fired_p == fired_j
    kinds = {k for f in fired_p for k in f}
    assert kinds == set(health.HealthMonitor.DETECTORS)
    rj, rp = jm.report(), pm.report()
    assert rp["anomalies"] == rj["anomalies"]
    for k in ("steps", "ewma_loss", "ewma_grad_norm", "consecutive_skips", "data_stall_fraction",
              "last", "bucket_names", "dumps"):
        assert rp[k] == rj[k], k
    if action == "dump":
        dj, dp = sorted(os.listdir(tmp_path / "jax")), sorted(os.listdir(tmp_path / "port"))
        assert dp == dj and len(dp) == cfg.get("dump_limit", 3)
        for b in dp:
            assert sorted(os.listdir(tmp_path / "port" / b)) == \
                sorted(os.listdir(tmp_path / "jax" / b))
            rep_p = json.loads((tmp_path / "port" / b / "report.json").read_text())
            rep_j = json.loads((tmp_path / "jax" / b / "report.json").read_text())
            for k in ("step", "fired", "record", "anomaly_counts", "bucket_names"):
                assert rep_p[k] == rep_j[k], k


def _snapshot_records():
    """Two registry snapshots with every section the summary reads: train,
    loss, fp16, anomalies, memory, serving (phases, wasted tokens),
    replicas, SLO, controller and the recorder's loss."""
    reg = MetricsRegistry()
    recs = []
    for k in range(2):
        reg.counter("train/steps").inc(5)
        for v in (10.0, 12.0, 30.0 + k):
            reg.histogram("train/step_time_ms").observe(v)
            reg.histogram("train/grad_norm").observe(v / 10)
        reg.gauge("train/tokens_per_sec").set(12345.5 + k)
        reg.gauge("train/mfu").set(0.4123 + k / 100)
        reg.gauge("train/loss").set(3.2 - k)
        reg.gauge("health/loss_ewma").set(3.3)
        reg.gauge("health/grad_norm").set(1.25)
        reg.gauge("train/loss_scale").set(1024.0)
        reg.gauge("train/skipped_steps").set(2)
        reg.gauge("health/consecutive_skips").set(k)
        reg.counter("health/anomalies", labelnames=("type",)).labels(type="loss_spike").inc(k)
        reg.counter("health/anomalies", labelnames=("type",)).labels(type="nonfinite")
        reg.gauge("train/data_stall_fraction").set(0.125)
        for name, v in (("mem/hbm_bytes_in_use", 3e9), ("mem/hbm_peak_bytes", 4e9),
                        ("mem/hbm_bytes_limit", 8e10), ("mem/hbm_headroom_bytes", 7.7e10)):
            reg.gauge(name, labelnames=("device",)).labels(device="cuda:0").set(v)
        reg.gauge("mem/host_rss_bytes").set(2.5e9)
        for v in (20.0, 45.0):
            reg.histogram("serving/ttft_ms").observe(v)
            reg.histogram("serving/tpot_ms").observe(v / 10)
            reg.histogram("serving/queue_wait_ms").observe(v / 4)
            reg.histogram("serving/phase_ms", labelnames=("phase", "replica")).labels(
                phase="prefill", replica="r0").observe(v)
            reg.histogram("serving/phase_ms", labelnames=("phase", "replica")).labels(
                phase="decode", replica="r0").observe(v / 3)
        for name, v in (("serving/queue_depth", 3), ("serving/running", 8),
                        ("serving/kv_block_utilization", 0.61), ("serving/kv_blocks_free", 100)):
            reg.gauge(name).set(v)
        for name, v in (("serving/prefix_cache_lookups", 10), ("serving/prefix_cache_hits", 4),
                        ("serving/spec_proposed_tokens", 40), ("serving/spec_accepted_tokens", 9),
                        ("serving/preemptions", 1), ("serving/rejected_requests", 2)):
            reg.counter(name).inc(v)
        reg.counter("serving/wasted_tokens", labelnames=("cause", "replica")).labels(
            cause="preempt", replica="r0").inc(7)
        reg.gauge("slo/burn_rate", labelnames=("objective", "window")).labels(
            objective="ttft_p99", window="60").set(1.5)
        reg.gauge("slo/burn_rate", labelnames=("objective", "window")).labels(
            objective="ttft_p99", window="5").set(2.5)
        reg.counter("slo/breaches", labelnames=("objective",)).labels(objective="ttft_p99").inc(k)
        reg.gauge("ctl/knob", labelnames=("name",)).labels(name="max_queue").set(8)
        reg.gauge("ctl/knob_baseline", labelnames=("name",)).labels(name="max_queue").set(16)
        reg.counter("ctl/actions", labelnames=("knob", "direction")).labels(
            knob="max_queue", direction="tighten").inc(k + 1)
        reg.gauge("ctl/last_action", labelnames=("knob", "direction", "reason")).labels(
            knob="max_queue", direction="tighten", reason="ttft_burn").set(7 + k)
        reg.gauge("events/dropped").set(3)
        reg.gauge("events/capacity").set(16384)
        recs.append({"ts": 1700000000.0 + 2 * k, "step": 5 * (k + 1), **reg.snapshot()})
    return recs


def test_summary_table_and_cli_text_match_the_jax_package(tmp_path, capsys):
    prev, rec = _snapshot_records()
    for a, b in ((rec, prev), (rec, None), (prev, None), ({"gauges": {}}, None)):
        want = jax_health.health_summary(a, b)
        assert health.health_summary(a, b) == want
        assert health.render_summary_table(want) == jax_health.render_summary_table(want)
        assert health.render_health_table(a, b) == jax_health.render_health_table(a, b)
    path = tmp_path / "t.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in (prev, rec)) + "{broken\n")
    assert health.read_last_snapshots(str(path), 5) == jax_health.read_last_snapshots(
        str(path), 5) == [prev, rec]
    for argv in ([str(path), "--once"], [str(path), "--json"],
                 [str(tmp_path / "missing.jsonl"), "--json"]):
        rc_p = health.health_cli(argv)
        out_p = capsys.readouterr().out
        rc_j = jax_health.health_cli(argv)
        out_j = capsys.readouterr().out
        assert (rc_p, out_p) == (rc_j, out_j), argv
    c = rec["counters"]
    assert health.labeled_series(c, "health/anomalies") == jax_health.labeled_series(
        c, "health/anomalies")
    h = rec["histograms"]
    assert health.multilabel_series(h, "serving/phase_ms") == jax_health.multilabel_series(
        h, "serving/phase_ms")


def test_health_off_and_config_dict():
    eng = deepspeed_tpu_torch.initialize(
        model=CausalLM(TransformerConfig(**LLAMA)), config=_config(), device="cpu")[0]
    assert eng.health_report() == {"enabled": False} and eng._health is None
    cfg = HealthConfig(**DETECT_CFG)
    d = health._config_dict(cfg)
    assert d == {k: v for k, v in jax_health._config_dict(JaxHealthConfig(**DETECT_CFG)).items()}
    assert dataclasses.is_dataclass(cfg)


def test_engine_feeds_checkpoint_failures_to_the_detector(tmp_path):
    import errno

    from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import CheckpointWriteError
    from deepspeed_tpu_torch.utils import fault_injection as fi
    config = _config(telemetry={"health": {**HEALTH_CFG, "ckpt_failure_consecutive": 2}},
                     checkpoint={"retries": 0, "retry_backoff_s": 0.0})
    get_registry().reset()
    eng = deepspeed_tpu_torch.initialize(
        model=CausalLM(TransformerConfig(**LLAMA)), config=config, device="cpu")[0]
    try:
        eng.train_batch(_batches(33, 1, 4)[0])
        for _ in range(2):
            with fi.inject(fi.FaultInjector().fail_writes(errno.EIO, count=-1)):
                with pytest.raises(CheckpointWriteError):
                    eng.save_checkpoint(str(tmp_path))
        assert eng.health_report()["anomalies"]["ckpt_failure"] == 1
        assert get_registry().snapshot()["counters"][
            'health/anomalies{type="ckpt_failure"}'] == 1
        eng.save_checkpoint(str(tmp_path))
        assert eng._health._consec_ckpt_failures == 0
    finally:
        eng.destroy()
        get_registry().reset()
