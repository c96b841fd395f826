"""``chip_smoke.py`` phase ``zero`` at a tiny size on the CPU, over gloo:
``cli run`` spawns this script's ``--worker zero`` rank (a 2-layer Llama,
fp32), which trains ZeRO stages 0-3 with AdamW and stages 0 and 2 with
LAMB and MoQ from the same weights; every stage's losses and state must equal its
optimizer's stage 0 bit for bit (one rank: a partition is the whole unit),
each partitioned run must issue its stage's collectives, and the output
line carries the reckoned bytes a rank would hold at dp 2, 4 and 8. The
rank's arguments reach the worker; a reference that is not the stage's
own fails the phase."""

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
    monkeypatch.setattr(chip_smoke, "ZERO_DIR", str(tmp_path / "zero"))
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # for the rank the phase spawns


def _line(capsys, phase):
    rec, = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{") and json.loads(line).get("phase") == phase]
    return rec


def test_zero_phase_on_gloo(tiny, capsys):
    state = {}
    chip_smoke.phase_zero(state, 0)
    rec = _line(capsys, "zero")
    assert rec["backend"] == "gloo" and rec["steps"] == chip_smoke.ZERO_STEPS
    assert set(rec["fingerprints_equal"].values()) == {True}
    runs = rec["runs"]
    assert [t for t, _, _ in chip_smoke.ZERO_RUNS] == list(runs)
    for tag, stage, lamb in chip_smoke.ZERO_RUNS:
        r = runs[tag]
        ref = runs["lamb_stage0" if lamb else "adamw_stage0"]
        assert r["losses"] == ref["losses"] and r["partitioned"] == (stage > 0)
        assert r["moq"] == lamb     # the LAMB runs are the train_lamb cell's, with MoQ
        assert len(r["step_s"]) == chip_smoke.ZERO_STEPS
        ops = r["comms_per_step"]
        if stage:
            assert r["group"] == ["dp"] and r["describe"].startswith(f"ZeRO stage {stage}")
            assert ops["all_gather"]["count"] >= 1 and ops["all_gather"]["bytes"] > 0
        if stage >= 2:
            assert ops["reduce_scatter"]["count"] >= 1
        # the bytes a rank would hold shrink with the world from stage 1 on
        totals = [r["reckoned_bytes_per_rank"][str(n)]["total"]
                  for n in chip_smoke.ZERO_RECKON_WORLDS]
        if stage:
            assert totals[0] > totals[1] > totals[2]
    assert "reckoned" in rec["reckoned_note"]
    assert "zero_launches" in state
    import deepspeed_tpu_torch.comm as dist
    assert not dist.has_process_group()


def test_zero_phase_fails_when_the_reference_differs(tiny, monkeypatch):
    """The phase's table names LAMB's stage 0 as AdamW stage 1's reference:
    the losses part, and the phase fails."""
    runs = list(chip_smoke.ZERO_RUNS)
    runs[1] = ("adamw_stage1", 1, True)
    monkeypatch.setattr(chip_smoke, "ZERO_RUNS", tuple(runs))
    with pytest.raises(RuntimeError, match="zero failed: adamw_stage1 losses"):
        chip_smoke.phase_zero({}, 0)


def test_zero_worker_takes_its_arguments(monkeypatch, tmp_path):
    seen = {}

    def worker(out, seed):
        seen.update(out=out, seed=seed, device=chip_smoke.CHECK_DEVICE,
                    model=chip_smoke.LAUNCH_MODEL)
        return 0
    monkeypatch.setattr(chip_smoke, "worker_zero", worker)
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cuda")
    monkeypatch.setattr(chip_smoke, "LAUNCH_MODEL", None)
    rc = chip_smoke.main(["--worker", "zero", "--worker-out", str(tmp_path), "--seed", "3",
                          "--worker-device", "cpu", "--worker-model", json.dumps(TINY)])
    assert rc == 0 and seen == {"out": str(tmp_path), "seed": 3, "device": "cpu", "model": TINY}
    cmd = chip_smoke._worker_cmd("zero", str(tmp_path), 3)
    assert cmd[1:3] == ["--worker", "zero"] and "--worker-model" in cmd
