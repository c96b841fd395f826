"""Phase ``serve_fleet`` of ``chip_smoke.py`` at a tiny size on the CPU
(fp32, the kernels' plain versions, so no launch rule): two replicas on one
weight tree and one host KV tier, the session trace replayed twice with
equal decisions, the prefill-to-decode handoff for every prompt of a block
or more, the breaker drain of r0 onto r1 (its /healthz 503, the router's
200), and the threaded fleet against one loop. Apart from the other phase
files so the test runner can place it on another worker."""

import json

import torch

import chip_smoke
from tests.test_torch_chip_smoke_serve_tier import on_the_cpu

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def test_serve_fleet_phase_runs_its_checks_on_the_cpu(monkeypatch, capsys):
    on_the_cpu(monkeypatch)
    state = {}
    chip_smoke.phase_serve_fleet(state, 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_fleet" and line["replicas"] == 2
    assert line["weights_shared"]
    assert line["replay"]["identical"] and "affinity" in line["replay"]["reasons"]
    assert line["handoff"]["handoffs"] == line["handoff"]["prompts_of_a_block"] == 9
    assert line["drain"]["healthz_router_r0"] == [200, 503] and line["drain"]["failovers"] > 0
    for part in ("replay", "handoff", "drain", "throughput"):
        assert line[part]["rows_parting_at_near_ties"] == 0
    assert line["throughput"]["fleet_tokens_per_s"] > 0
    assert "serve_fleet_launches" in state
