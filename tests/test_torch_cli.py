"""The port's command line, ``python -m deepspeed_tpu_torch.cli``, against
the JAX package's ``dscli``: ``health`` and ``top`` over a telemetry JSONL,
``trace <rid>`` over a port serve's ``events.jsonl`` and ``trace
--validate`` over the port's exports (the same output as ``dscli``), the
not-ported subcommands (each names its ROADMAP.md item and returns 2), and
the module entry point. ``ckpt verify`` is in
``test_torch_fault_tolerance.py``, ``ctl`` in ``test_torch_controller.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu import cli as jax_cli
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor.events import get_flight_recorder
from deepspeed_tpu_torch.monitor.metrics import get_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64, max_seq=128)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """A telemetry JSONL (two train snapshots) and the events.jsonl and
    chrome trace of a port serve, all written by the port."""
    d = tmp_path_factory.mktemp("cli")
    get_registry().reset()
    model = CausalLM(TransformerConfig(**MODEL))
    jsonl = str(d / "telemetry.jsonl")
    eng = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
                "telemetry": {"jsonl_path": jsonl, "steps_per_snapshot": 1,
                              "health": {"enabled": True}}})[0]
    ids = np.random.default_rng(0).integers(0, 64, size=(2, 16))
    for _ in range(2):
        eng.train_batch({"input_ids": ids})
    eng.destroy()
    get_registry().reset()
    rec = get_flight_recorder()
    rec.clear()
    inf = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                             telemetry={"events": True})
    r = np.random.default_rng(1)
    inf.generate_batch([r.integers(0, 64, size=n) for n in (20, 7)], max_new_tokens=5)
    events = rec.write_jsonl(str(d / "events.jsonl"))
    trace = inf.export_serving_trace(str(d / "trace.json"))
    rec.disable()
    rec.clear()
    get_registry().reset()
    return {"jsonl": jsonl, "events": events, "trace": trace, "dir": d}


def _both(capsys, port_fn, jax_fn, argv):
    rc = port_fn(argv)
    out = capsys.readouterr().out
    jrc = jax_fn(argv)
    jout = capsys.readouterr().out
    return (rc, out), (jrc, jout)


@pytest.mark.parametrize("argv", [["--once"], ["--json"]])
def test_health_and_top_print_the_jax_screens(exports, capsys, argv):
    path = exports["jsonl"]
    got, want = _both(capsys, cli.COMMANDS["health"], jax_cli._health,
                      [path] + argv)
    assert got == want and got[0] == 0
    got, want = _both(capsys, cli.COMMANDS["top"], jax_cli._top, [path] + argv)
    assert got == want and got[0] == 0
    assert cli.main(["health", path] + argv) == 0
    out = capsys.readouterr().out
    if argv == ["--json"]:
        s = json.loads(out)
        assert s["train"]["steps"] == 2 and "anomalies" in s
    else:
        assert "train" in out and "anomalies none" in out


def test_trace_anatomy_and_validation(exports, capsys):
    events = exports["events"]
    for rid in ("0", "1"):
        for extra in ([], ["--json"]):
            got, want = _both(capsys, lambda a: cli.main(["trace"] + a), jax_cli._trace,
                              [rid, "--events", events] + extra)
            assert got == want and got[0] == 0
    assert cli.main(["trace", "42", "--events", events]) == 1
    assert "no events" in capsys.readouterr().out
    assert cli.main(["trace", "--validate", events, exports["trace"]]) == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 2
    bad = exports["dir"] / "bad.jsonl"
    bad.write_text(json.dumps({"ts_ns": 1, "kind": "not.a.kind"}) + "\n")
    assert cli.main(["trace", "--kind", "events", "--validate", str(bad)]) == 1
    assert "not.a.kind" in capsys.readouterr().out
    kinds = cli.load_validator()._event_kinds()
    from deepspeed_tpu_torch.monitor.events import EVENT_KINDS
    assert kinds == set(EVENT_KINDS)


@pytest.mark.parametrize("cmd", sorted(cli.NOT_PORTED))
def test_not_ported_commands_name_their_item(cmd, capsys):
    assert cli.main([cmd, "--anything"]) == 2
    err = capsys.readouterr().err
    assert "is not ported to deepspeed_tpu_torch yet" in err
    assert f"ROADMAP.md {cli.NOT_PORTED[cmd][1]}" in err


def test_module_entry_point_and_usage(capsys):
    assert cli.main([]) == 0
    assert "usage: python -m deepspeed_tpu_torch.cli" in capsys.readouterr().out
    assert cli.main(["frobnicate"]) == 2
    assert set(cli.COMMANDS) == set(jax_cli._COMMANDS)
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.cli", "serve"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 2 and "queue 1: async serving" in out.stderr
