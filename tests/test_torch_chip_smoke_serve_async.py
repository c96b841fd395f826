"""Phase ``serve_async`` of ``chip_smoke.py`` at a tiny size on the CPU
(fp32, the kernels' plain versions, so no launch rule): the replay run twice
identical, each planted fault read as the phase reads it on the card, the
threaded run with two SSE requests, a cancellation and the free blocks, the
front-end's /healthz and /metrics, and the controller's prefill_chunk
action. Apart from the other phase files so the test runner can place it on
another worker."""

import json

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def test_serve_async_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    from deepspeed_tpu_torch.models import llama

    tiny = dict(n_layer=2, d_model=64, n_head=2, d_ff=128, vocab_size=128, max_seq=1024)

    def tiny_llama(seed):
        model = llama("7b", **tiny)
        return model, model.init_params(torch.Generator().manual_seed(seed))

    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ASYNC_DTYPE", "fp32")
    monkeypatch.setattr(chip_smoke, "_llama7b", tiny_llama)
    monkeypatch.setattr(chip_smoke, "SERVE_MAX_NEW", 8)
    monkeypatch.setattr(chip_smoke, "serve_launch_rule", lambda cfg, actions: {
        "flash_attention_fwd": 0, "paged_decode_attention": 0})
    chip_smoke.phase_serve_async({}, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_async" and line["requests"] == 12
    assert line["replay"]["identical"]
    faults = line["faults"]
    assert faults["request_prefill_pre"]["rows_equal_unfaulted"] == 12
    assert faults["engine_decode_post"]["restarts"] == 1
    assert faults["engine_decode_post"]["rows_equal_unfaulted"] == 12
    assert faults["past_max_request_retries"]["status"][5] == "error"
    threaded = line["threaded"]
    assert threaded["sse_rows_equal_handle"] == 2 and threaded["healthz"] == [200, 503]
    assert threaded["free_blocks_after_drain"] == threaded["free_blocks_start"]
    assert 0 < threaded["cancelled_generated"] < 8
    assert threaded["ttft_ms"]["count"] > 0 and threaded["metrics_counters_checked"] > 0
    assert line["knob"]["moved_to"] == [line["knob"]["ladder"][1]]
    assert line["knob"]["chunks"] and max(line["knob"]["chunks"]) == line["knob"]["ladder"][1]
    assert np.isfinite(line["tokens_per_s_ratio"]) and np.isfinite(line["burst"]["tokens_per_s"])
    assert faults["engine_decode_post"]["rows_parting_at_near_ties"] == 0
