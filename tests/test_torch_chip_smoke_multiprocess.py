"""The ``chip_smoke.py`` phases of the multi-process slice (``comm``,
``launch``) at a tiny size on the CPU, where they run over gloo: the comm
checks and ``dscli bench`` at one rank; ``cli run`` spawning this script's
``--worker launch`` rank (a 2-layer Llama, fp32), its losses and state
against the same steps run in the test's process, and the elastic agent's
restart. Planted faults must fail their phase: a collective that returns
the wrong values, a logger that misses a call, a reference run that is not
the launched one."""

import json

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=128, max_seq=64,
            pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
            norm_eps=1e-6, attention_backend="flash")


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "LAUNCH_MODEL", TINY)
    monkeypatch.setattr(chip_smoke, "LAUNCH_DIR", str(tmp_path / "launch"))
    monkeypatch.setattr(chip_smoke, "COMM_SHAPE", (2, 16))
    monkeypatch.setattr(chip_smoke, "COMM_BENCH_SIZES", ((4096, 32768),))
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # for the ranks the phases spawn


def _lines(capsys, phase):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{") and json.loads(line).get("phase") == phase]


def test_comm_phase_on_gloo(tiny, capsys):
    chip_smoke.phase_comm({}, 0)
    rec, = _lines(capsys, "comm")
    assert rec["backend"] == "gloo"
    assert {v for k, v in rec["gaps"].items() if "PRODUCT" not in k} == {0.0}
    assert max(v for k, v in rec["gaps"].items() if "PRODUCT" in k) <= chip_smoke.COMM_PRODUCT_TOL
    assert len(rec["bench"]) == 5 * 2 and rec["bench_header"]
    # fp32 [2, 16]: 4 ops + PRODUCT at 128 bytes; bf16: 4 at 64, PRODUCT's 64
    # elements at 128; the barrier's 4
    assert rec["records"]["all_reduce"] == {"128": 6, "64": 4, "4": 1}
    import deepspeed_tpu_torch.comm as dist
    assert not dist.has_process_group()


@pytest.mark.parametrize("fault", ["values", "logger"])
def test_comm_phase_fails_on_a_planted_fault(tiny, monkeypatch, fault):
    import deepspeed_tpu_torch.comm as dist
    real = dist.broadcast
    if fault == "values":
        monkeypatch.setattr(dist, "broadcast", lambda t, **kw: real(t, **kw) * 2)
    else:
        monkeypatch.setattr(dist, "broadcast", lambda t, **kw: real.__wrapped__(t, **kw))
    with pytest.raises(RuntimeError, match="comm failed"):
        chip_smoke.comm_checks(0)
    assert not dist.has_process_group()


def test_launch_phase_on_gloo(tiny, capsys):
    state = {}
    chip_smoke.phase_launch(state, 0)
    rec, = _lines(capsys, "launch")
    assert rec["losses"] == rec["launched_losses"] and rec["fingerprint_equal"]
    assert rec["backend"] == "gloo" and rec["rank_env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert rec["elastic"]["state"] == "SUCCEEDED" and rec["elastic"]["restarts"] == 1
    assert rec["elastic"]["return_codes"] == [0]
    assert rec["spawn_s"] > 0 and len(rec["launched_step_s"]) == chip_smoke.LAUNCH_STEPS


def test_launch_phase_fails_when_the_reference_differs(tiny, monkeypatch):
    """The in-process run on another seed's weights: its losses and state
    part from the launched rank's, and the phase fails."""
    real = chip_smoke._launch_setup
    monkeypatch.setattr(chip_smoke, "_launch_setup", lambda seed: real(seed + 1))
    with pytest.raises(RuntimeError, match="launched losses"):
        chip_smoke.phase_launch({}, 0)
