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
import torch

import deepspeed_tpu_torch
from deepspeed_tpu import cli as jax_cli
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.monitor.events import get_flight_recorder
from deepspeed_tpu_torch.monitor.metrics import get_registry

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

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


@pytest.mark.parametrize("cmd", ["bench", "lint", "run", "ssh"])
def test_not_ported_commands_name_their_item(cmd, capsys):
    """The commands that were refused: ``lint`` still is, naming its item;
    ``run``, ``bench`` and ``ssh`` (the launcher and comm/) now parse their
    own arguments, so an unknown flag is argparse's error, not a refusal."""
    if cmd in cli.NOT_PORTED:
        assert cli.main([cmd, "--anything"]) == 2
        err = capsys.readouterr().err
        assert "is not ported to deepspeed_tpu_torch yet" in err
        assert f"ROADMAP.md {cli.NOT_PORTED[cmd][1]}" in err
        return
    with pytest.raises(SystemExit) as exit_:
        cli.main([cmd, "--help"])
    assert exit_.value.code == 0
    out = capsys.readouterr()
    assert "usage:" in out.out and "is not ported" not in out.out + out.err


def test_module_entry_point_and_usage(capsys, tmp_path):
    assert cli.main([]) == 0
    assert "usage: python -m deepspeed_tpu_torch.cli" in capsys.readouterr().out
    assert cli.main(["frobnicate"]) == 2
    assert set(cli.COMMANDS) == set(jax_cli._COMMANDS)
    # from the command line, a command outside the port (lint, the
    # trace-safety analyzer) is refused naming its item
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.cli", "lint",
                          "train.py"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 2 and "tools/dslint for the port" in out.stderr


def test_serve_streams_a_completion_and_drains_on_sigterm():
    """``serve`` on the CPU with the tiny Llama preset on port 0: one
    streamed completion over HTTP equals the engine's own greedy decode,
    then ``ServeSignalHandler.trigger(SIGTERM)`` stops intake, drains the
    loop and ``serve`` returns 128 + SIGTERM, as the JAX ``serve_main``
    does."""
    import http.client
    import signal
    import threading

    from deepspeed_tpu_torch.models import llama
    model = llama("tiny")
    params = model.init_params(torch.Generator().manual_seed(0))
    holder, ready, rc = {}, threading.Event(), {}

    def cb(server, serving):
        holder.update(server=server, serving=serving)
        ready.set()

    argv = ["serve", "--model", "llama:tiny", "--device", "cpu", "--dtype", "fp32",
            "--port", "0", "--max-new", "4", "--grace", "60"]
    from deepspeed_tpu_torch.inference import serve
    t = threading.Thread(target=lambda: rc.update(rc=serve.serve_main(
        argv[1:], model=model, params=params, ready_cb=cb)), daemon=True)
    t.start()
    assert ready.wait(120), "serve never bound its socket"
    serving = holder["serving"]
    prompt = [3, 14, 15, 92, 65]
    conn = http.client.HTTPConnection("127.0.0.1", holder["server"].server_address[1],
                                      timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": prompt, "max_tokens": 4, "stream": True}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    lines = r.read().decode().splitlines()
    chunks = [json.loads(x[6:]) for x in lines if x.startswith("data: ") and x != "data: [DONE]"]
    toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop" and "data: [DONE]" in lines
    serving._signal_handler.trigger(signal.SIGTERM)
    t.join(120)
    assert not t.is_alive() and rc["rc"] == 128 + signal.SIGTERM
    with pytest.raises(RuntimeError, match="draining|stopped"):
        serving.add_request(prompt)
    ref = serving.engine.generate(np.asarray(prompt)[None, :], max_new_tokens=4)[0]
    assert toks == [int(x) for x in np.asarray(ref)[len(prompt):]]


def _jax_profile_out(argv, capsys):
    rc = jax_cli._profile(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("top", [20, 1])
def test_profile_chrome_trace_prints_the_jax_table(exports, capsys, top):
    """``profile <trace.json>`` prints what the JAX ``_profile`` prints for
    the same file, ``--top`` included; a file with no complete spans and a
    missing path return 1 in both."""
    argv = [exports["trace"], "--top", str(top)]
    want_rc, want = _jax_profile_out(argv, capsys)
    assert cli.main(["profile"] + argv) == want_rc == 0
    got = capsys.readouterr().out
    assert got == want and "total ms" in got
    if top == 1:
        assert "more (raise --top)" in got
    empty = exports["dir"] / "empty_trace.json"
    empty.write_text(json.dumps({"traceEvents": [{"ph": "i", "name": "x", "ts": 0}]}))
    for path in (str(empty), str(exports["dir"] / "missing.json")):
        want_rc, want = _jax_profile_out([path], capsys)
        assert cli.main(["profile", path]) == want_rc == 1
        assert capsys.readouterr().out == want


def test_profile_summarizes_a_profile_window_directory(tmp_path, capsys):
    """``profile <dir>`` reads the ``trace_<n>.json`` captures a
    ``ProfileWindow`` wrote (the port's torch.profiler traces) one by one,
    in capture order; a directory without captures returns 1."""
    from deepspeed_tpu_torch.monitor.trace import ProfileWindow
    win = ProfileWindow(log_dir=str(tmp_path / "prof"))
    x = torch.randn(64, 64)
    for _ in range(2):
        win.arm(1)
        win.tick()
        (x @ x).sum()
        win.tick()
    assert win.captures == 2
    assert cli.main(["profile", str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    assert "2 capture(s)" in out
    first, second = out.index("trace_0.json: "), out.index("trace_1.json: ")
    assert first < second and out.count("total ms") == 2
    (tmp_path / "none").mkdir()
    assert cli.main(["profile", str(tmp_path / "none")]) == 1
    assert "no trace_<n>.json captures" in capsys.readouterr().out


def test_serve_with_two_replicas_routes_and_hands_off():
    """``serve --replicas 2 --replica-roles prefill,decode`` on the CPU: the
    two engines share one weight tree and one host KV tier, a completion of
    a prompt of more than a block goes through the prefill replica's
    handoff and equals the engine's greedy decode, and ``/healthz`` reads
    the fleet."""
    import http.client
    import signal
    import threading

    from deepspeed_tpu_torch.inference import serve
    from deepspeed_tpu_torch.inference.router import ReplicaRouter
    from deepspeed_tpu_torch.models import llama
    model = llama("tiny")
    params = model.init_params(torch.Generator().manual_seed(0))
    holder, ready, rc = {}, threading.Event(), {}

    def cb(server, serving):
        holder.update(server=server, serving=serving)
        ready.set()

    argv = ["--model", "llama:tiny", "--device", "cpu", "--dtype", "fp32", "--port", "0",
            "--max-new", "4", "--grace", "60", "--block-size", "16", "--replicas", "2",
            "--replica-roles", "prefill,decode"]
    t = threading.Thread(target=lambda: rc.update(rc=serve.serve_main(
        argv, model=model, params=params, ready_cb=cb)), daemon=True)
    t.start()
    assert ready.wait(120), "serve never bound its socket"
    router = holder["serving"]
    assert isinstance(router, ReplicaRouter) and router.roles == ["prefill", "decode"]
    e0, e1 = (r.engine for r in router.replicas)
    assert e1._kv_host_pool is e0._kv_host_pool is not None
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(e0.params.parameters(), e1.params.parameters()))
    port = holder["server"].server_address[1]
    prompt = [int(x) for x in np.random.default_rng(2).integers(0, 256, size=37)]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps({"prompt": prompt, "max_tokens": 4}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    toks = json.loads(r.read())["choices"][0]["token_ids"]
    conn.request("GET", "/healthz")
    h = conn.getresponse()
    body = json.loads(h.read())
    assert h.status == 200 and body["total_replicas"] == 2 and body["healthy_replicas"] == 2
    assert [d["reason"] for d in router.decisions] == ["handoff", "prefill"]
    router._signal_handler.trigger(signal.SIGTERM)
    t.join(120)
    assert not t.is_alive() and rc["rc"] == 128 + signal.SIGTERM
    ref = e0.generate(np.asarray(prompt)[None, :], max_new_tokens=4)[0]
    assert toks == [int(x) for x in np.asarray(ref)[len(prompt):]]
