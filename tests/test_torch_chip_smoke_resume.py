"""Phase ``resume`` of ``chip_smoke.py`` on the CPU: its dataset, launch rule,
state accounting and fingerprint helpers, and the phase at a tiny size.
Apart from ``test_torch_chip_smoke.py`` so the test runner can place it on
another worker."""

import json

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


# ----------------------------------------------------------------------- #
# phase resume's helpers

RESUME_TINY = dict(n_layer=2, n_head=4, d_model=128, d_ff=256, vocab_size=256, max_seq=64)


def test_resume_dataset_is_seeded_motifs():
    data = chip_smoke.resume_dataset(32000, 0)
    assert len(data) == chip_smoke.RESUME_SAMPLES == 64
    periods = []
    for s in data:
        x = s["input_ids"]
        assert x.shape == (chip_smoke.TRAIN_SEQ,) and x.dtype == np.int32
        period = next(p for p in range(8, 33) if np.array_equal(x[p:], x[:-p]))
        periods.append(period)
    assert min(periods) >= 8 and max(periods) <= 32 and len(set(periods)) > 5
    again, other = chip_smoke.resume_dataset(32000, 0), chip_smoke.resume_dataset(32000, 1)
    assert all(np.array_equal(a["input_ids"], b["input_ids"]) for a, b in zip(data, again))
    assert not np.array_equal(data[0]["input_ids"], other[0]["input_ids"])


def _tiny_resume_engine(seed=0, init_seed=1, config=None):
    from deepspeed_tpu_torch.models import llama
    data = chip_smoke.resume_dataset(256, seed, n=16, seq=64)
    return chip_smoke.resume_engine(data, seed, init_seed, config=config, device="cpu",
                                    model=llama("7b", **RESUME_TINY))


def test_train_launch_rule_counts_the_train_cell_rule():
    engine = _tiny_resume_engine()
    want = chip_smoke.train_launch_rule(engine)
    assert want == {"flash_attention_fwd": 8, "flash_attention_bwd_dq": 4,
                    "flash_attention_bwd_dkv": 4, "fused_adam": 21, "fused_ce_fwd": 2,
                    "fused_ce_ds": 2, "fused_ce_dh_gemm": 2, "fused_ce_dw_gemm": 2}


def test_state_bytes_reckons_a_tag(tmp_path):
    """18 B a parameter at bf16 with gas 2 (params 2, masters, mu, nu and
    acc_grads 4 each), plus the scalars; the tag adds only its headers."""
    engine = _tiny_resume_engine()
    n = sum(p.numel() for p in engine.state.params.parameters())
    need = chip_smoke.state_bytes(engine)
    assert 18 * n <= need <= 18 * n + 64
    engine.save_checkpoint(str(tmp_path), tag="t")
    got = chip_smoke.tag_bytes(str(tmp_path / "t"))
    assert need < got < need + 64 * 1024


def test_state_fingerprint_sees_a_step_and_a_failed_load_leaves_it(tmp_path):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import (
        STATE_FILE, CheckpointCorruptError)
    from deepspeed_tpu_torch.utils import fault_injection as fi
    engine = _tiny_resume_engine()
    before = chip_smoke.state_fingerprint(engine)
    assert chip_smoke.state_fingerprint(engine) == before
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.train_batch()             # WarmupLR: lr 0 at step 0, the params move at step 1
    engine.train_batch()
    engine._rng.manual_seed(5)       # no dropout here: the stream moves only if set
    after = chip_smoke.state_fingerprint(engine)
    changed = {k for k in before if before[k] != after[k]}
    assert {"counters.global_steps", "params.embed.tokens", "master.layers.attn.wq",
            "opt_state_flat.leaf_0", "rng"} <= changed
    fi.bit_flip(str(tmp_path / "t" / STATE_FILE))
    with pytest.raises(CheckpointCorruptError):
        engine.load_checkpoint(str(tmp_path), tag="t")
    assert chip_smoke.state_fingerprint(engine) == after


def test_loss_gap():
    assert chip_smoke.loss_gap([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert chip_smoke.loss_gap([1.1, 2.0], [1.0, 2.5]) == pytest.approx(0.2)


def test_resume_phase_runs_its_checks_on_the_cpu(monkeypatch, tmp_path, capsys):
    """phase_resume at the tiny shape on the CPU (no kernels, so no launch
    rule): bit-equal resumed losses and masters, both faults above 0, the
    corrupt load raising with the state untouched, the tag deleted."""
    import json

    from deepspeed_tpu_torch.models import llama

    class Accelerator:
        def reset_peak_memory_stats(self):
            pass

        def max_memory_allocated(self):
            return 0

    real, real_dataset = chip_smoke.resume_engine, chip_smoke.resume_dataset
    monkeypatch.setattr(chip_smoke, "resume_engine",
                        lambda data, seed, init_seed, config=None: real(
                            data, seed, init_seed, config=config, device="cpu",
                            model=llama("7b", **RESUME_TINY)))
    monkeypatch.setattr(chip_smoke, "resume_dataset",
                        lambda vocab, seed: real_dataset(RESUME_TINY["vocab_size"], seed, seq=64))
    monkeypatch.setattr(chip_smoke, "train_launch_rule", lambda engine: {})
    monkeypatch.setattr(chip_smoke, "RESUME_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    import deepspeed_tpu_torch.accelerator as accel
    monkeypatch.setattr(accel, "get_accelerator", lambda *a: Accelerator())
    chip_smoke.phase_resume({}, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "resume" and line["resumed_equal"]
    assert line["losses_resumed"] == line["losses_uninterrupted"]
    assert min(line["fault_loss_gap"].values()) > 0.0
    assert not (tmp_path / "ckpt").exists()
