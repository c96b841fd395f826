"""Fault-tolerant training in the port: the cases of
``tests/unit/test_fault_tolerance.py`` against ``deepspeed_tpu_torch``'s
engine on the CPU — crash-safe two-phase checkpointing, verified
auto-resume with walk-back, injected I/O faults, the async writer,
retention, preemption, resume identity, the dataloader's resume, and the
surfaces: ``ckpt verify`` of ``python -m deepspeed_tpu_torch.cli`` and the
health monitor's ``ckpt_failure`` detector. The metrics cases are in
``test_torch_train_telemetry.py``."""

import errno
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.runtime.checkpoint_engine import safe_engine
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import CheckpointCorruptError
from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import (
    MANIFEST, STATE_FILE, CheckpointWriteError)
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader, RepeatingLoader,
                                                    resume_loader_iterator)
from deepspeed_tpu_torch.utils import fault_injection as fi

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

pytestmark = pytest.mark.chaos

VOCAB, SEQ = 64, 16
MODEL = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=SEQ,
             remat=False)


def _batch(i):
    rng = np.random.default_rng(1000 + i)
    return {"input_ids": rng.integers(0, VOCAB, (8, SEQ)).astype(np.int32)}


def _config(extra=None):
    config = {
        "train_micro_batch_size_per_gpu": 8,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": 1},
        "steps_per_print": 0,
        "checkpoint": {"retries": 2, "retry_backoff_s": 0.0},
    }
    config.update(extra or {})
    return config


def _make_engine(extra_config=None, training_data=None):
    model = CausalLM(TransformerConfig(**MODEL))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config=_config(extra_config),
        training_data=training_data, device="cpu")
    return engine


@pytest.fixture(scope="module")
def engine():
    e = _make_engine()
    e.train_batch(_batch(0))
    yield e
    e.destroy()


@pytest.fixture(scope="module")
def engine_b():
    e = _make_engine()
    yield e
    e.destroy()


def _tag_total_bytes(tag_dir):
    return sum(os.path.getsize(os.path.join(tag_dir, f)) for f in os.listdir(tag_dir))


class TestAtomicCommit:

    def test_crash_mid_write_leaves_latest_and_previous_intact(self, engine, tmp_path):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="t1")
        assert (tmp_path / "latest").read_text() == "t1"
        with pytest.raises(fi.SimulatedCrash):
            with fi.inject(fi.FaultInjector(kill_at_byte=200)):
                engine.save_checkpoint(d, tag="t2")
        assert not (tmp_path / "t2").exists()
        assert (tmp_path / "latest").read_text() == "t1"
        assert safe_engine.verify_tag(str(tmp_path / "t1")).intact

    @pytest.mark.parametrize("frac", [0.01, 0.5, 0.99])
    def test_kill_at_byte_offset_then_auto_resume(self, engine, tmp_path, frac):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="good")
        saved_step = engine.global_steps
        total = _tag_total_bytes(str(tmp_path / "good"))
        with pytest.raises(fi.SimulatedCrash):
            with fi.inject(fi.FaultInjector(kill_at_byte=int(total * frac))):
                engine.save_checkpoint(d, tag="partial")
        assert not (tmp_path / "partial").exists()
        path, _ = engine.auto_resume(d)
        assert path is not None and path.endswith("good")
        assert engine.global_steps == saved_step

    def test_latest_pointer_never_moves_backward(self, tmp_path):
        d = str(tmp_path)
        arr = {"w": np.arange(3.0)}
        safe_engine.write_tag(d, safe_engine.CheckpointPayload(
            tag="sync12", arrays=arr, meta={"global_steps": 12}, global_steps=12))
        safe_engine.write_tag(d, safe_engine.CheckpointPayload(
            tag="async10", arrays=arr, meta={"global_steps": 10}, global_steps=10))
        assert (tmp_path / "latest").read_text() == "sync12"
        assert safe_engine.verify_tag(str(tmp_path / "async10")).intact
        safe_engine.write_tag(d, safe_engine.CheckpointPayload(
            tag="sync14", arrays=arr, meta={"global_steps": 14}, global_steps=14))
        assert (tmp_path / "latest").read_text() == "sync14"

    def test_tmp_debris_swept_by_retention_gc(self, engine, tmp_path):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="a")
        with pytest.raises(fi.SimulatedCrash):
            with fi.inject(fi.FaultInjector(kill_at_byte=100)):
                engine.save_checkpoint(d, tag="b")
        assert (tmp_path / ".tmp.b").exists()
        engine._config.checkpoint_config.keep_last = 4
        try:
            engine.save_checkpoint(d, tag="c")
        finally:
            engine._config.checkpoint_config.keep_last = 0
        assert not (tmp_path / ".tmp.b").exists()

    def test_interrupted_overwrite_recovered_not_swept(self, tmp_path):
        d = str(tmp_path)
        mk = lambda v, step: safe_engine.CheckpointPayload(  # noqa: E731
            tag="t", arrays={"w": np.full(4, float(v))}, meta={"v": v}, global_steps=step)
        safe_engine.write_tag(d, mk(1, 1))
        os.replace(str(tmp_path / "t"), str(tmp_path / "t.old"))
        safe_engine.write_tag(d, mk(2, 2))
        os.replace(str(tmp_path / "t"), str(tmp_path / ".tmp.t"))
        assert safe_engine.recover_interrupted(d) == ["t"]
        assert safe_engine.verify_tag(str(tmp_path / "t")).intact
        flat = safe_engine.read_npz(str(tmp_path / "t" / STATE_FILE))
        assert flat["w"][0] == 2.0
        safe_engine.gc_tags(d, keep_last=4)
        assert not (tmp_path / "t.old").exists()
        assert safe_engine.verify_tag(str(tmp_path / "t")).intact

    def test_parked_old_copy_restored_when_tmp_unusable(self, tmp_path):
        d = str(tmp_path)
        safe_engine.write_tag(d, safe_engine.CheckpointPayload(
            tag="t", arrays={"w": np.ones(4)}, meta={}, global_steps=1))
        os.replace(str(tmp_path / "t"), str(tmp_path / "t.old"))
        (tmp_path / ".tmp.t").mkdir()
        assert safe_engine.recover_interrupted(d) == ["t"]
        assert safe_engine.verify_tag(str(tmp_path / "t")).intact


class TestVerifyAndWalkBack:

    def _three_tags(self, engine, tmp_path):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="t1")
        engine.train_batch(_batch(1))
        engine.save_checkpoint(d, tag="t2")
        engine.train_batch(_batch(2))
        engine.save_checkpoint(d, tag="t3")
        return d

    def test_bit_flip_every_manifest_entry_is_caught(self, engine, tmp_path):
        d = self._three_tags(engine, tmp_path)
        tag_dir = os.path.join(d, "t3")
        with open(os.path.join(tag_dir, MANIFEST)) as f:
            listed = list(json.load(f)["files"])
        assert STATE_FILE in listed and "meta.json" in listed
        for name in listed:
            path = os.path.join(tag_dir, name)
            idx = fi.bit_flip(path)
            rep = safe_engine.verify_tag(tag_dir)
            assert not rep.intact
            assert any(name in e for e in rep.errors), (name, rep.errors)
            fi.bit_flip(path, byte_index=idx)
        idx = fi.bit_flip(os.path.join(tag_dir, MANIFEST))
        assert not safe_engine.verify_tag(tag_dir).intact
        fi.bit_flip(os.path.join(tag_dir, MANIFEST), byte_index=idx)
        assert safe_engine.verify_tag(tag_dir).intact

    def test_walk_back_to_newest_intact(self, engine, tmp_path):
        d = self._three_tags(engine, tmp_path)
        with open(os.path.join(d, "t2", "meta.json")) as f:
            t2_steps = json.load(f)["global_steps"]
        fi.bit_flip(os.path.join(d, "t3", STATE_FILE))
        path, _ = engine.auto_resume(d)
        assert path.endswith("t2")
        assert engine.global_steps == t2_steps

    def test_all_corrupt_raises_never_silent(self, engine, tmp_path):
        d = self._three_tags(engine, tmp_path)
        for t in ("t1", "t2", "t3"):
            fi.bit_flip(os.path.join(d, t, STATE_FILE))
        with pytest.raises(CheckpointCorruptError):
            engine.auto_resume(d)

    @pytest.mark.parametrize("name", ["meta.json", STATE_FILE])
    def test_corrupt_explicit_tag_is_all_or_nothing(self, engine, tmp_path, name):
        """A corrupt tag never leaves a half-restored engine: params,
        masters' absence, moments, counters and the dropout stream are
        bit-identical to before the failed load."""
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="bad")
        engine.train_batch(_batch(3))            # the engine moves past the tag
        fi.bit_flip(os.path.join(d, "bad", name))
        w_before = engine.state.params["embed"]["tokens"].detach().clone()
        mu_before = engine.state.opt_state.mu["embed.tokens"].clone()
        steps_before, count_before = engine.global_steps, engine.state.opt_state.count
        rng_before = engine._rng.get_state().clone()
        with pytest.raises(CheckpointCorruptError, match="failed verification.*blake2b"):
            engine.load_checkpoint(d, tag="bad")
        assert torch.equal(engine.state.params["embed"]["tokens"], w_before)
        assert torch.equal(engine.state.opt_state.mu["embed.tokens"], mu_before)
        assert engine.global_steps == steps_before
        assert engine.state.opt_state.count == count_before
        assert torch.equal(engine._rng.get_state(), rng_before)

    def test_strict_flag(self, engine, tmp_path):
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        assert engine.load_checkpoint(empty) == (None, {})
        with pytest.raises(FileNotFoundError):
            engine.load_checkpoint(empty, strict=True)
        with pytest.raises(FileNotFoundError):
            engine.load_checkpoint(empty, tag="nope", strict=True)


class TestIOFaults:

    def test_transient_enospc_retries_to_success(self, engine, tmp_path):
        d = str(tmp_path)
        inj = fi.FaultInjector().fail_writes(errno.ENOSPC, count=1)
        with fi.inject(inj):
            engine.save_checkpoint(d, tag="t")       # retry budget = 2
        assert inj.writes_seen > 0
        assert safe_engine.verify_tag(str(tmp_path / "t")).intact
        assert (tmp_path / "latest").read_text() == "t"

    def test_persistent_eio_fails_cleanly(self, engine, tmp_path):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="ok")
        with fi.inject(fi.FaultInjector().fail_writes(errno.EIO, count=-1)):
            with pytest.raises(CheckpointWriteError):
                engine.save_checkpoint(d, tag="doomed")
        assert not (tmp_path / "doomed").exists()
        assert not (tmp_path / ".tmp.doomed").exists()
        assert (tmp_path / "latest").read_text() == "ok"
        assert safe_engine.verify_tag(str(tmp_path / "ok")).intact
        path, _ = engine.auto_resume(d)
        assert path.endswith("ok")


class TestAsyncWriter:

    def test_async_commit_matches_sync(self, engine, tmp_path):
        da, ds_ = str(tmp_path / "a"), str(tmp_path / "s")
        engine.save_checkpoint(da, tag="t", asynchronous=True)
        engine.flush_checkpoints()
        engine.save_checkpoint(ds_, tag="t", asynchronous=False)
        assert safe_engine.verify_tag(os.path.join(da, "t")).intact
        fa = safe_engine.read_npz(os.path.join(da, "t", STATE_FILE))
        fs = safe_engine.read_npz(os.path.join(ds_, "t", STATE_FILE))
        assert set(fa) == set(fs)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fs[k])

    def test_async_failure_surfaces_on_flush(self, engine, tmp_path):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="ok")
        with fi.inject(fi.FaultInjector().fail_writes(errno.ENOSPC, count=-1)):
            engine.save_checkpoint(d, tag="doomed", asynchronous=True)
            with pytest.raises(CheckpointWriteError):
                engine.flush_checkpoints()
        assert (tmp_path / "latest").read_text() == "ok"
        assert not (tmp_path / "doomed").exists()

    def test_async_crash_mid_write(self, engine, tmp_path):
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="ok")
        with fi.inject(fi.FaultInjector(kill_at_byte=500)):
            engine.save_checkpoint(d, tag="dead", asynchronous=True)
            with pytest.raises(fi.SimulatedCrash):
                engine.flush_checkpoints()
        assert not (tmp_path / "dead").exists()
        assert engine.auto_resume(d)[0].endswith("ok")

    def test_bounded_queue_and_delayed_writes(self, engine, tmp_path):
        d = str(tmp_path)
        with fi.inject(fi.FaultInjector(delay_per_write_s=0.02)):
            for i in range(3):
                engine.save_checkpoint(d, tag=f"q{i}", asynchronous=True)
            depth = engine._ckpt_writer.queue_depth
            engine.flush_checkpoints()
        assert depth >= 1
        assert engine._ckpt_writer.queue_depth == 0
        for i in range(3):
            assert safe_engine.verify_tag(str(tmp_path / f"q{i}")).intact
        assert (tmp_path / "latest").read_text() == "q2"


class TestRetention:

    def test_keep_last_never_gcs_latest(self, engine, tmp_path):
        d = str(tmp_path)
        engine._config.checkpoint_config.keep_last = 2
        try:
            for i in range(4):
                engine.train_batch(_batch(10 + i))
                engine.save_checkpoint(d, tag=f"global_step{engine.global_steps}")
        finally:
            engine._config.checkpoint_config.keep_last = 0
        tags = sorted(t for t in os.listdir(d) if os.path.isdir(os.path.join(d, t)))
        assert len(tags) == 2
        assert (tmp_path / "latest").read_text() in tags
        for t in tags:
            assert safe_engine.verify_tag(os.path.join(d, t)).intact

    def test_gc_protects_newest_verified_tag(self, engine, tmp_path):
        d = str(tmp_path)
        for tag in ("t1", "t2", "t3"):
            engine.train_batch(_batch(20))
            engine.save_checkpoint(d, tag=tag)
        fi.bit_flip(os.path.join(d, "t2", STATE_FILE))
        fi.bit_flip(os.path.join(d, "t3", STATE_FILE))
        deleted = safe_engine.gc_tags(d, keep_last=1)
        assert "t1" not in deleted
        assert safe_engine.verify_tag(os.path.join(d, "t1")).intact
        assert "t2" in deleted
        assert os.path.isdir(os.path.join(d, "t3"))


class TestPreemption:

    def test_sigterm_takes_emergency_save_and_exits(self, engine, tmp_path):
        d = str(tmp_path)
        engine.enable_preemption_handler(d)
        try:
            with pytest.raises(SystemExit) as ei:
                os.kill(os.getpid(), signal.SIGTERM)
                for _ in range(100):
                    time.sleep(0.01)
            assert ei.value.code == 128 + signal.SIGTERM
        finally:
            engine.disable_preemption_handler()
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
        rep = safe_engine.newest_intact_tag(d)
        assert rep is not None and rep.global_steps == engine.global_steps
        path, _ = engine.auto_resume(d)
        assert path is not None

    def test_sigint_covered_and_uninstall(self, engine, tmp_path):
        d = str(tmp_path)
        engine.enable_preemption_handler(d, exit_on_signal=False)
        try:
            os.kill(os.getpid(), signal.SIGINT)
            for _ in range(100):
                time.sleep(0.01)
                if safe_engine.newest_intact_tag(d) is not None:
                    break
        finally:
            engine.disable_preemption_handler()
        assert safe_engine.newest_intact_tag(d) is not None
        assert engine._preemption is None


    def test_preemption_save_config_installs_the_handler(self, tmp_path):
        e = _make_engine({"checkpoint": {"preemption_save": True, "save_dir": str(tmp_path)}})
        try:
            assert e._preemption is not None and e._preemption.save_dir == str(tmp_path)
            assert signal.getsignal(signal.SIGTERM) == e._preemption._handle
        finally:
            e.destroy()
        assert e._preemption is None
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


class TestResumeIdentity:

    def test_loss_curve_identity_after_resume(self, engine, engine_b, tmp_path):
        """Save mid-run (async), 'crash', auto-resume into another engine:
        the resumed losses are bit-identical to the uninterrupted run."""
        d = str(tmp_path)
        for i in range(2):
            engine.train_batch(_batch(50 + i))
        engine.save_checkpoint(d, asynchronous=True)
        engine.flush_checkpoints()
        uninterrupted = [float(engine.train_batch(_batch(60 + i))) for i in range(3)]
        path, _ = engine_b.auto_resume(d)
        assert path is not None
        assert engine_b.global_steps == engine.global_steps - 3
        resumed = [float(engine_b.train_batch(_batch(60 + i))) for i in range(3)]
        assert resumed == uninterrupted, (resumed, uninterrupted)

    def test_dataloader_fast_forward_identity(self, engine, engine_b, tmp_path):
        d = str(tmp_path)

        def stream():
            i = 0
            while True:
                yield _batch(100 + i)
                i += 1

        engine.set_dataiterator(stream())
        for _ in range(3):
            engine.train_batch()
        engine.save_checkpoint(d)
        assert engine._data_progress["iterations"] == 3
        uninterrupted = [float(engine.train_batch()) for _ in range(2)]
        engine.set_dataiterator(None)
        engine_b.set_dataiterator(stream())
        path, _ = engine_b.auto_resume(d)
        assert path is not None
        assert engine_b._data_progress["iterations"] == 3
        resumed = [float(engine_b.train_batch()) for _ in range(2)]
        engine_b.set_dataiterator(None)
        assert resumed == uninterrupted, (resumed, uninterrupted)

    def test_engine_owned_dataloader_resume_identity(self, tmp_path):
        d = str(tmp_path)
        rng = np.random.default_rng(77)
        data = [{"input_ids": rng.integers(0, VOCAB, (SEQ,)).astype(np.int32)}
                for _ in range(24)]
        a = _make_engine(training_data=data)
        try:
            for _ in range(2):
                a.train_batch()
            a.save_checkpoint(d)
            uninterrupted = [float(a.train_batch()) for _ in range(3)]
        finally:
            a.destroy()
        b = _make_engine(training_data=data)
        try:
            path, _ = b.auto_resume(d)
            assert path is not None
            resumed = [float(b.train_batch()) for _ in range(3)]
        finally:
            b.destroy()
        assert resumed == uninterrupted, (resumed, uninterrupted)

    def test_set_dataloader_resume_rolls_past_epoch(self, tmp_path):
        d = str(tmp_path)
        rng = np.random.default_rng(55)
        data = [{"input_ids": rng.integers(0, VOCAB, (SEQ,)).astype(np.int32)}
                for _ in range(24)]            # 3 micro-batches an epoch at bs 8
        a = _make_engine(training_data=data)
        try:
            for _ in range(4):                 # one epoch + 1
                a.train_batch()
            a.save_checkpoint(d)
            uninterrupted = [float(a.train_batch()) for _ in range(2)]
        finally:
            a.destroy()
        b = _make_engine()
        try:
            b.set_dataloader(DeepSpeedDataLoader(data, batch_size=8))
            path, _ = b.auto_resume(d)         # must not StopIteration
            assert path is not None
            resumed = [float(b.train_batch()) for _ in range(2)]
        finally:
            b.destroy()
        assert resumed == uninterrupted, (resumed, uninterrupted)

    def test_meta_records_data_progress(self, engine, tmp_path):
        d = str(tmp_path)
        before = dict(engine._data_progress)
        engine.save_checkpoint(d, tag="p")
        with open(os.path.join(d, "p", "meta.json")) as f:
            meta = json.load(f)
        assert meta["data_progress"] == before


class TestDataloaderResume:

    def test_resume_loader_iterator_positions_exactly(self):
        data = [np.array([i]) for i in range(12)]
        ref = RepeatingLoader(DeepSpeedDataLoader(data, batch_size=4, shuffle=True, seed=7))
        stream = [next(ref) for _ in range(9)]        # 3 epochs of 3 batches
        it = resume_loader_iterator(DeepSpeedDataLoader(data, batch_size=4, shuffle=True,
                                                        seed=7), consumed_batches=5)
        got = [next(it) for _ in range(4)]
        for a, b in zip(got, stream[5:9]):
            np.testing.assert_array_equal(a, b)

    def test_resume_empty_loader_raises_not_spins(self):
        it = resume_loader_iterator([], consumed_batches=3)
        with pytest.raises(RuntimeError, match="no batches"):
            next(it)
        one_shot = iter([np.array([0]), np.array([1])])
        it = resume_loader_iterator(one_shot, consumed_batches=5)
        with pytest.raises(RuntimeError, match="no batches"):
            next(it)


class TestSurfaces:

    def test_cli_ckpt_verify(self, engine, tmp_path, capsys):
        from deepspeed_tpu_torch.cli import main
        d = str(tmp_path)
        engine.save_checkpoint(d, tag="good")
        engine.save_checkpoint(d, tag="rotten", save_latest=False)
        assert main(["ckpt", "verify", d]) == 0
        fi.bit_flip(os.path.join(d, "rotten", STATE_FILE))
        rc = main(["ckpt", "verify", d])
        out = capsys.readouterr().out
        assert rc == 1
        assert "INTACT" in out and "CORRUPT" in out
        assert "rotten" in out and "blake2b mismatch" in out
        assert "<- latest" in out
        assert main(["ckpt", "verify", d, "--tag", "good"]) == 0
        assert main(["ckpt", "verify", str(tmp_path / "empty")]) == 1

    def test_health_ckpt_failure_detector(self):
        from deepspeed_tpu_torch.monitor.config import HealthConfig
        from deepspeed_tpu_torch.monitor.health import HealthMonitor
        from deepspeed_tpu_torch.monitor.metrics import MetricsRegistry

        reg = MetricsRegistry(enabled=True)
        hm = HealthMonitor(HealthConfig(enabled=True, action="record",
                                        ckpt_failure_consecutive=2),
                           registry=reg)
        assert hm.observe_checkpoint(False) == []
        assert hm.observe_checkpoint(False) == ["ckpt_failure"]
        assert hm.report()["anomalies"]["ckpt_failure"] == 1
        # success resets the run; a single later failure does not fire
        assert hm.observe_checkpoint(True) == []
        assert hm.observe_checkpoint(False) == []
        # and the anomaly counter series exists with an explicit value
        snap = reg.snapshot()
        assert snap["counters"]['health/anomalies{type="ckpt_failure"}'] == 1

    def test_async_writer_failures_reach_the_detector(self, tmp_path):
        """The async writer's completion callback feeds the engine's health
        monitor (``_notify_ckpt_result``): two persisting failures fire."""
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        e = _make_engine({"telemetry": {"health": {"enabled": True, "action": "record",
                                                   "ckpt_failure_consecutive": 2}},
                          "checkpoint": {"retries": 0, "retry_backoff_s": 0.0}})
        try:
            e.train_batch(_batch(0))
            with fi.inject(fi.FaultInjector().fail_writes(errno.ENOSPC, count=-1)):
                for tag in ("a", "b"):
                    e.save_checkpoint(str(tmp_path), tag=tag, asynchronous=True)
                    with pytest.raises(CheckpointWriteError):
                        e.flush_checkpoints(timeout=30)
            assert e.health_report()["anomalies"]["ckpt_failure"] == 1
        finally:
            e.destroy()
            get_registry().reset()
