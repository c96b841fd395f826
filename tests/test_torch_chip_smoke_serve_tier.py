"""Phase ``serve_tier`` of ``chip_smoke.py`` at a tiny size on the CPU (fp32,
the kernels' plain versions, so no launch rule): the filler wave demotes
every full block of turn 1, turn 2 fetches them bit-equal to their spill and
prefills only the tails, its rows match the tier-off and the device-hit
references, a persistent fetch fault recomputes, and the pool drains clean.
Apart from the other phase files so the test runner can place it on another
worker."""

import json

import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TINY = dict(n_layer=2, d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=1024)


def tiny_llama(seed):
    from deepspeed_tpu_torch.models import llama
    model = llama("7b", **TINY)
    return model, model.init_params(torch.Generator().manual_seed(seed))


def on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DTYPE", "fp32")
    monkeypatch.setattr(chip_smoke, "_llama7b", tiny_llama)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 8)
    monkeypatch.setattr(chip_smoke, "serve_launch_rule", lambda cfg, actions: {
        "flash_attention_fwd": 0, "paged_decode_attention": 0})


def test_serve_tier_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    on_the_cpu(monkeypatch)
    state = {}
    chip_smoke.phase_serve_tier(state, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_tier" and line["requests"] == 12
    assert line["spills"] > 0 and line["fetched_blocks"] > 0
    assert line["turn2_prefill_tokens"] == \
        line["turn2_prompt_tokens"] - line["turn2_cached_tokens"] > 0
    assert 0 < line["turn2_fetch_tokens"] <= line["turn2_cached_tokens"]
    assert line["blocks_checked_bit_equal"] > 0 and line["blocks_unequal"] == 0
    assert line["fetch_fault"]["kv_host_errors"] > 0
    assert line["transfer"]["fetched_bit_equal"]
    for ref in line["references"].values():
        assert ref["rows_parting_at_near_ties"] == 0
    assert line["references"]["device_hit"]["prefix_cache_hit_tokens"] > 0
    assert line["ttft_ms"]["tier"]["count"] == 12
    assert "serve_tier_launches" in state
