"""Training telemetry in the port: the JAX engine's series and events
against the port's on the same tiny Llama, weights and batches (the JAX
engine on a one-device mesh, ``attention_backend="flash"``): equal counts
of steps, tokens, step-time / grad-norm / data-wait observations, the same
``train.step`` and ``ckpt.*`` events, loss and grad-norm within fp32
tolerance. Also the csv monitor's files and columns against the JAX
engine's, the ``wall_clock_breakdown`` timers, the trio's phase series, the
MFU gauge (0 on the CPU, following ``DS_PEAK_TFLOPS``), the JSONL and
chrome-trace sinks, the profile window, ``emergency_save``'s
``events.jsonl``, the host-sync budget (one a step with telemetry on, none
off) and the checkpoint metrics cases of the JAX fault-tolerance tests."""

import errno
import importlib.util
import json
import os
from collections import Counter
from pathlib import Path

import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch.accelerator.abstract_accelerator as port_acc
from deepspeed_tpu.monitor import events as jax_events
from deepspeed_tpu.monitor import metrics as jax_metrics
from deepspeed_tpu_torch.monitor import events as port_events
from deepspeed_tpu_torch.monitor import metrics as port_metrics
from deepspeed_tpu_torch.monitor.metrics import validate_snapshot
from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import CheckpointWriteError
from deepspeed_tpu_torch.utils import fault_injection as fi
from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer
from tests.test_torch_training import (LLAMA, _batches, _config, _jax_params, _port,
                                       one_device_mesh)  # noqa: F401 (fixture)

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

_VT_PATH = Path(__file__).resolve().parents[1] / "tools" / "validate_trace.py"
_spec = importlib.util.spec_from_file_location("validate_trace", _VT_PATH)
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)

LOSS_TOL = 1e-5      # relative: the training parity tests' per-step loss limit
NORM_TOL = 1e-4      # relative: a sum of three pre-clip norms in fp32


@pytest.fixture(autouse=True)
def clean_state():
    """Both packages' process-global registries and recorders, fresh per
    test and left off after it."""
    def _reset():
        for mod in (jax_metrics, port_metrics):
            mod.get_registry().reset()
            mod.get_registry().set_enabled(True)
        for mod in (jax_events, port_events):
            mod.get_flight_recorder().disable()
            mod.get_flight_recorder().clear()

    _reset()
    yield
    _reset()


def _engine(jparams=None, **over):
    if jparams is None:
        _, jparams = _jax_params(LLAMA)
    return _port(LLAMA, jparams, _config(**over))


def _train(engine, n=3, seed=1):
    return [float(engine.train_batch(b)) for b in _batches(seed, n, 4)]


# --------------------------------------------------------------------- #
# against the JAX engine


def _series(snap):
    train = lambda d: {k: v for k, v in d.items()
                       if k.startswith(("train/", "checkpoint/"))}
    return (train(snap["counters"]), train(snap["gauges"]),
            {k: v["count"] for k, v in train(snap["histograms"]).items()})


def test_train_series_and_events_match_the_jax_engine(one_device_mesh, tmp_path):
    jmodel, jparams = _jax_params(LLAMA)
    config = _config(telemetry={"events": True})
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=one_device_mesh)
    peng = _port(LLAMA, jparams, config)
    for batch in _batches(1, 3, 4):
        jeng.train_batch(batch)
        peng.train_batch(batch)
    jeng.save_checkpoint(str(tmp_path / "jax"), asynchronous=False)
    peng.save_checkpoint(str(tmp_path / "port"), asynchronous=False)
    jsnap, psnap = jeng.telemetry_snapshot(), peng.telemetry_snapshot()
    validate_snapshot(psnap)
    jc, jg, jh = _series(jsnap)
    pc, pg, ph = _series(psnap)
    assert pc == jc and ph == jh and set(pg) == set(jg)
    assert pc["train/steps"] == 3 and pc["train/tokens"] == 3 * 4 * 64
    assert ph["train/step_time_ms"] == ph["train/grad_norm"] == 3
    assert pg["train/loss"] == pytest.approx(jg["train/loss"], rel=LOSS_TOL)
    assert psnap["histograms"]["train/grad_norm"]["sum"] == pytest.approx(
        jsnap["histograms"]["train/grad_norm"]["sum"], rel=NORM_TOL)
    assert pg["train/mfu"] == jg["train/mfu"] == 0.0     # no published CPU peak
    jev = jax_events.get_flight_recorder().snapshot()
    pev = port_events.get_flight_recorder().snapshot()
    assert [(e.kind, e.step) for e in pev] == [(e.kind, e.step) for e in jev]
    assert Counter(e.kind for e in pev) == {"train.step": 3, "ckpt.snapshot": 1,
                                            "ckpt.serialize": 1, "ckpt.commit": 1}
    commit = next(e for e in pev if e.kind == "ckpt.commit")
    assert commit.data["bytes"] > 0 and commit.data["tag"] == "global_step3"
    assert set(psnap["compile"]) == {"total", "by_fn", "events"}
    jeng.destroy()
    peng.destroy()


def test_csv_monitor_files_and_columns_match_the_jax_engine(one_device_mesh, tmp_path):
    jmodel, jparams = _jax_params(LLAMA)
    dirs = {}
    for name in ("jax", "port"):
        csv = {"enabled": True, "output_path": str(tmp_path / name), "job_name": "job"}
        config = _config(csv_monitor=csv, telemetry={"steps_per_snapshot": 1,
                                                     "enabled": True})
        if name == "jax":
            eng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                                    config=config, mesh=one_device_mesh)
        else:
            eng = _port(LLAMA, jparams, config)
        for batch in _batches(1, 2, 4):
            eng.train_batch(batch)
        dirs[name] = tmp_path / name / "job"
        eng.destroy()
    port_files = sorted(p.name for p in dirs["port"].iterdir())
    jax_files = sorted(p.name for p in dirs["jax"].iterdir())
    # the JAX engine also publishes its compile series; the port has none
    assert set(port_files) == {f for f in jax_files if "compile" not in f}
    assert "Train_Samples_train_loss.csv" in port_files
    assert "Telemetry_train_step_time_ms_p99.csv" in port_files
    for name in ("Train_Samples_train_loss.csv", "Train_Samples_lr.csv",
                 "Telemetry_train_steps.csv"):
        rows = [(dirs[k] / name).read_text().splitlines() for k in ("port", "jax")]
        assert rows[0][0] == rows[1][0] == "step,value"
        assert [r.split(",")[0] for r in rows[0]] == [r.split(",")[0] for r in rows[1]]
        got = [float(r.split(",")[1]) for r in rows[0][1:]]
        want = [float(r.split(",")[1]) for r in rows[1][1:]]
        assert got == pytest.approx(want, rel=LOSS_TOL)


# --------------------------------------------------------------------- #
# the port on its own


def test_telemetry_changes_no_loss_and_syncs_once_a_step():
    _, jparams = _jax_params(LLAMA)
    runs = {}
    for tel in (None, {"events": True}):
        over = {"bf16": {"enabled": True}}
        if tel is not None:
            over["telemetry"] = tel
        eng = _engine(jparams=jparams, **over)
        syncs, losses = [], []
        for batch in _batches(1, 3, 4):
            s0 = port_acc.syncs
            loss = eng.train_batch(batch)
            syncs.append(port_acc.syncs - s0)
            losses.append(loss.float().item())
        runs[tel is not None] = (losses, syncs)
        eng.destroy()
    assert runs[True][0] == runs[False][0]           # bit-equal
    assert runs[False][1] == [0, 0, 0] and runs[True][1] == [1, 1, 1]


def test_events_off_allocates_nothing(monkeypatch):
    eng = _engine(telemetry={"enabled": True})
    assert eng._tel_events is None

    def boom(*a, **k):
        raise AssertionError("Event allocated with events disabled")

    monkeypatch.setattr(port_events, "Event", boom)
    _train(eng, 1)
    assert len(port_events.get_flight_recorder()) == 0
    off = _engine()
    assert off._telemetry is None and off.telemetry_snapshot() == {}
    assert off.export_trace("unused.json") is None
    eng.destroy()
    off.destroy()


def test_trio_phase_series_and_wall_clock_timers():
    eng = _engine(telemetry={"events": True}, wall_clock_breakdown=True)
    assert isinstance(eng.timers, SynchronizedWallClockTimer)
    micro = _batches(2, 2, 2)
    s0 = port_acc.syncs
    for b in micro:
        loss = eng.forward(b)
        eng.backward(loss)
    eng.step()
    # wall_clock_breakdown: a sync at each timer start and stop; telemetry:
    # one a phase and one loss read at the boundary
    assert port_acc.syncs - s0 == 2 * 5 + 5 + 1
    t = SynchronizedWallClockTimer
    means = eng.timers.get_mean([t.FORWARD_GLOBAL_TIMER, t.BACKWARD_GLOBAL_TIMER,
                                 t.STEP_GLOBAL_TIMER], reset=False)
    assert set(means) == {"fwd", "bwd", "step"} and all(v > 0 for v in means.values())
    assert len(eng.timers("fwd").elapsed_records) == 2
    snap = eng.telemetry_snapshot()
    counts = {k: v["count"] for k, v in snap["histograms"].items()}
    assert counts['train/phase_time_ms{phase="fwd"}'] == 2
    assert counts['train/phase_time_ms{phase="step"}'] == 1
    assert counts["train/data_wait_ms"] == 1
    phases = [e.data["phase"] for e in port_events.get_flight_recorder().snapshot()
              if e.kind == "train.phase"]
    assert phases == ["fwd", "bwd", "fwd", "bwd", "step"]
    assert snap["gauges"]["train/loss"] == pytest.approx(float(loss.detach()))
    off = _engine()
    assert off.timers("fwd").elapsed() == 0 and off.timers.get_mean(["fwd"]) == {}
    eng.destroy()
    off.destroy()


def test_mfu_reads_zero_on_the_cpu_and_follows_ds_peak_tflops(monkeypatch):
    eng = _engine(telemetry=True)
    _train(eng, 1)
    g = eng.telemetry_snapshot()["gauges"]
    assert g["train/mfu"] == 0.0 and g["train/achieved_tflops_per_chip"] > 0
    monkeypatch.setenv("DS_PEAK_TFLOPS", "2e-6")
    _train(eng, 1, seed=2)
    g = eng.telemetry_snapshot()["gauges"]
    fpt = eng.module.flops_per_token(64)
    assert g["train/achieved_tflops_per_chip"] == pytest.approx(
        fpt * g["train/tokens_per_sec"] / 1e12)
    assert g["train/mfu"] == pytest.approx(g["train/achieved_tflops_per_chip"] / 2e-6)
    eng.destroy()


def test_jsonl_cadence_and_chrome_trace(tmp_path):
    path = str(tmp_path / "tel.jsonl")
    eng = _engine(telemetry={"enabled": True, "jsonl_path": path, "steps_per_snapshot": 2,
                             "chrome_trace_path": str(tmp_path / "host.json")})
    _train(eng, 4)
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["step"] for ln in lines] == [2, 4]
    for ln in lines:
        validate_snapshot(ln)
    trace = eng.export_trace()
    assert validate_trace.validate_path(trace, kind="chrome") == []
    doc = json.loads(Path(trace).read_text())
    assert sum(e["name"] == "train_batch" for e in doc["traceEvents"]) >= 4
    eng.destroy()


def test_fp16_skip_series():
    eng = _engine(telemetry={"events": True},
                  fp16={"enabled": True, "initial_scale_power": 40})
    _train(eng, 2)
    g = eng.telemetry_snapshot()["gauges"]
    assert g["train/skipped_steps"] == eng.skipped_steps >= 1
    assert g["train/loss_scale"] == eng.loss_scale
    eng.destroy()


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
        Path(path).write_text('{"traceEvents": []}')


def test_profile_window_through_train_batch(monkeypatch, tmp_path):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    eng = _engine()                     # telemetry off: the window still works
    eng.profile(steps=2, log_dir=str(tmp_path / "p"))
    _train(eng, 4)
    assert _FakeProfile.calls == ["start", "stop"]
    assert (tmp_path / "p" / "trace_0.json").exists()
    eng.profile(steps=100)
    _train(eng, 1)
    eng.destroy()                       # stops the dangling capture
    assert _FakeProfile.calls[-1] == "stop"
    cfg = _engine(telemetry={"enabled": True, "profile": {"start_step": 1, "num_steps": 2,
                                                          "dir": str(tmp_path / "c")}})
    assert cfg._profiler._armed == {"start": 1, "steps": 2, "dir": str(tmp_path / "c")}
    cfg.destroy()


def test_emergency_save_ships_events_jsonl(tmp_path):
    eng = _engine(telemetry={"events": True})
    _train(eng, 1)
    save_dir = str(tmp_path / "emergency")
    eng.emergency_save(save_dir)
    p = os.path.join(save_dir, "events.jsonl")
    assert validate_trace.validate_path(p, kind="events") == []
    kinds = [json.loads(ln)["kind"] for ln in Path(p).read_text().splitlines()]
    assert "train.step" in kinds and "ckpt.snapshot" in kinds and "ckpt.commit" in kinds
    port_events.get_flight_recorder().disable()     # as in a process that never enabled it
    off = _engine()
    off.emergency_save(str(tmp_path / "quiet"))
    assert not (tmp_path / "quiet" / "events.jsonl").exists()
    eng.destroy()
    off.destroy()


# --------------------------------------------------------------------- #
# the metrics cases of the JAX fault-tolerance tests


def test_persistent_eio_counts_a_failure(tmp_path):
    eng = _engine()
    d = str(tmp_path)
    eng.save_checkpoint(d, tag="ok")
    reg = port_metrics.get_registry()
    fails0 = reg.counter("checkpoint/failures").value
    saves0 = reg.counter("checkpoint/saves").value
    with fi.inject(fi.FaultInjector().fail_writes(errno.EIO, count=-1)):
        with pytest.raises(CheckpointWriteError):
            eng.save_checkpoint(d, tag="doomed")
    assert reg.counter("checkpoint/failures").value == fails0 + 1
    assert reg.counter("checkpoint/saves").value == saves0
    assert (tmp_path / "latest").read_text() == "ok"
    eng.destroy()


def test_ckpt_retry_event_and_async_writer_metrics(tmp_path):
    eng = _engine(telemetry={"events": True})
    _train(eng, 1)
    eng._config.checkpoint_config.retry_backoff_s = 0.0
    inj = fi.FaultInjector().fail_writes(errno.ENOSPC, path_substr="state.npz", count=1)
    with fi.inject(inj):
        eng.save_checkpoint(str(tmp_path / "sync"), asynchronous=False)
    retries = [e for e in port_events.get_flight_recorder().snapshot()
               if e.kind == "ckpt.retry"]
    assert len(retries) == 1 and retries[0].data["attempt"] == 1
    eng.save_checkpoint(str(tmp_path / "async"), tag="a", asynchronous=True)
    eng.flush_checkpoints()
    snap = port_metrics.get_registry().snapshot()
    assert snap["counters"]["checkpoint/saves"] == 2
    assert snap["gauges"]["checkpoint/queue_depth"] == 0
    assert snap["histograms"]["checkpoint/save_ms"]["count"] == 2
    assert snap["histograms"]["checkpoint/snapshot_ms"]["count"] == 2
    assert snap["histograms"]["checkpoint/bytes"]["min"] > 0
    eng.destroy()
