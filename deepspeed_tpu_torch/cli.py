"""The port's command line (counterpart of ``deepspeed_tpu/cli.py``, the
JAX package's ``dscli``), run as ``python -m deepspeed_tpu_torch.cli
<command> [args...]``:

- ``health <jsonl> [--once|--json]`` — the health screen over a telemetry
  sink (``telemetry.jsonl_path`` or the sampler's path)
- ``top <url|jsonl>`` — the serving / training dashboard (scrapes
  ``/metrics`` or tails a sampler JSONL)
- ``ckpt verify <dir>`` — checkpoint integrity audit (per-tag manifest check)
- ``trace --validate <path>...`` — chrome-trace / events.jsonl schema check;
  ``trace <request-id> --events <jsonl>`` — one request's latency anatomy
- ``ctl replay|explain <events.jsonl>`` — adaptive-controller decision-ledger
  audit (rc 1 when the replay diverges from the recorded decisions)
- ``serve [--model m] [--port p] [--device d]`` — the OpenAI-style
  completions endpoint over the always-on async serving loop
  (``inference/serve.py``; ``--slo-*``, ``--adaptive`` and the sampler flags
  stand the control plane up beside it)

``run``, ``report``, ``bench``, ``lint``, ``profile``,
``elastic``, ``autotune`` and ``ssh`` are not ported: each prints the
refusal naming its ROADMAP.md item and returns 2. Nothing here imports
torch until ``serve`` runs.
"""

from __future__ import annotations

import os
import sys

from deepspeed_tpu_torch.monitor.health import health_cli
from deepspeed_tpu_torch.monitor.top import top_cli

#: the JAX package's subcommands the port does not have yet, with the
#: ROADMAP.md item that brings each
NOT_PORTED = {
    "run": ("the launcher (dscli run)", "queue 1: launcher/"),
    "report": ("the environment report (dscli report)", "queue 1: env_report.py"),
    "bench": ("the collective micro-benchmarks (dscli bench)", "queue 1: comm/"),
    "lint": ("the trace-safety analyzer (dscli lint)", "queue 1: tools/dslint for the port"),
    "profile": ("the profile summarizer (dscli profile)", "queue 1: profiling/"),
    "elastic": ("the elastic-config inspector (dscli elastic)", "queue 1: elasticity/"),
    "autotune": ("the config autotuner (dscli autotune)", "queue 1: autotuning/"),
    "ssh": ("the host broadcaster (dscli ssh)", "queue 1: launcher/"),
}


def _ckpt(argv):
    """``ckpt verify <dir>`` full-checks every tag's blake2b manifest and
    prints INTACT/CORRUPT per tag; exit code 1 when any tag is corrupt."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli ckpt", description="checkpoint maintenance tools")
    sub = parser.add_subparsers(dest="action", required=True)
    vp = sub.add_parser("verify", help="verify every tag's manifest")
    vp.add_argument("dir", type=str, help="checkpoint save_dir (tag parent)")
    vp.add_argument("--tag", type=str, default=None, help="verify only this tag")
    args = parser.parse_args(argv)

    from deepspeed_tpu_torch.runtime.checkpoint_engine import safe_engine

    save_dir = os.path.abspath(args.dir)
    reports = ([safe_engine.verify_tag(os.path.join(save_dir, args.tag))]
               if args.tag else
               [safe_engine.verify_tag(r.path) for r in safe_engine.list_tags(save_dir)])
    if not reports:
        print(f"no checkpoint tags under {save_dir}")
        return 1
    latest = safe_engine._latest_target(save_dir)
    corrupt = 0
    for rep in reports:
        if rep.legacy:
            status = "LEGACY  (orbax tag: loadable, no manifest to verify)"
        elif rep.intact:
            status = "INTACT"
        else:
            corrupt += 1
            status = "CORRUPT (" + "; ".join(rep.errors) + ")"
        steps = "-" if rep.global_steps is None else str(rep.global_steps)
        mark = " <- latest" if rep.tag == latest else ""
        print(f"{rep.tag:<28} step {steps:<10} {status}{mark}")
    if latest and all(r.tag != latest for r in reports) and not args.tag:
        corrupt += 1
        print(f"latest -> {latest!r}: tag missing (CORRUPT pointer)")
    print(f"{len(reports)} tag(s), {corrupt} corrupt")
    return 1 if corrupt else 0


def load_validator():
    """``tools/validate_trace.py`` of the checkout, loaded by path, its
    event catalogue the port's ``EVENT_KINDS`` (the tool would otherwise
    look for the JAX package's)."""
    import importlib.util

    from deepspeed_tpu_torch.monitor.events import EVENT_KINDS
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "validate_trace.py")
    if not os.path.isfile(path):
        raise RuntimeError(f"tools/validate_trace.py not found at {path} (run from a source "
                           "checkout)")
    spec = importlib.util.spec_from_file_location("validate_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._event_kinds = lambda: set(EVENT_KINDS)
    return mod


def _trace(argv):
    """``trace <request-id> --events <jsonl>`` prints one request's latency
    anatomy (``<request-id>`` an integer rid or a trace id like ``t0``,
    which prints every leg of the causal chain); ``--validate <path>...``
    schema-checks chrome-trace JSON / events.jsonl exports (rc 1 on
    violations)."""
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli trace",
        description="request latency anatomy + chrome-trace/events.jsonl schema validation")
    parser.add_argument("request_id", nargs="?", default=None,
                        help="rid (integer) or trace id (t<seq>) to decompose; needs --events")
    parser.add_argument("--events", metavar="PATH", default=None,
                        help="flight-recorder events.jsonl export (FlightRecorder.write_jsonl)")
    parser.add_argument("--json", action="store_true",
                        help="print the anatomy as JSON instead of the phase table")
    parser.add_argument("--validate", nargs="+", metavar="PATH", default=None,
                        help="file(s) to schema-validate")
    parser.add_argument("--kind", choices=("auto", "chrome", "events"), default="auto")
    args = parser.parse_args(argv)
    if args.validate is not None:
        return load_validator().main(["--kind", args.kind] + args.validate)
    if args.request_id is None:
        parser.error("need a <request-id> (with --events) or --validate")
    if args.events is None:
        parser.error("anatomy needs --events <events.jsonl> (export one with "
                     "get_flight_recorder().write_jsonl)")
    from deepspeed_tpu_torch.monitor.anatomy import (format_anatomy, format_trace_anatomy,
                                                     request_anatomy, resolve_request_id,
                                                     trace_anatomy)
    events = []
    with open(args.events) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    trace, rid = resolve_request_id(args.request_id)
    if rid is not None:
        a = request_anatomy(events, rid)
        if a is None:
            print(f"rid {rid}: no events in {args.events}")
            return 1
        print(json.dumps(a) if args.json else format_anatomy(a))
        return 0
    t = trace_anatomy(events, trace)
    if t is None:
        print(f"trace {trace}: no req.enqueue carries it in {args.events}")
        return 1
    print(json.dumps(t) if args.json else format_trace_anatomy(t))
    return 0


def _ctl(argv):
    """``ctl replay`` re-runs the pure decision core over the recorded
    ``ctl.observe`` trace and diffs against the recorded ``ctl.decide``
    sequence (rc 0 on an exact reproduction, rc 1 on divergence);
    ``ctl explain`` prints every knob movement with the observation that
    triggered it."""
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli ctl",
        description="adaptive-controller decision-ledger audit (monitor/controller.py)")
    sub = parser.add_subparsers(dest="action", required=True)
    rp = sub.add_parser("replay", help="re-run the decision core over the recorded "
                                       "observations and diff")
    rp.add_argument("events", help="events.jsonl ledger export")
    rp.add_argument("--json", action="store_true",
                    help="print the replayed action sequence as JSON")
    xp = sub.add_parser("explain", help="print the human-readable decision story")
    xp.add_argument("events", help="events.jsonl ledger export")
    args = parser.parse_args(argv)

    from deepspeed_tpu_torch.monitor.controller import (explain_decisions, recorded_decisions,
                                                        replay_decisions)
    if args.action == "explain":
        lines = explain_decisions(args.events)
        if not lines:
            print(f"{args.events}: no ctl.* events (run with telemetry.ctl enabled and "
                  "export the recorder)")
            return 1
        for line in lines:
            print(line)
        return 0
    try:
        replayed = replay_decisions(args.events)
    except ValueError as e:
        print(f"replay failed: {e}")
        return 1
    recorded = recorded_decisions(args.events)
    if args.json:
        print(json.dumps(replayed))
    if replayed == recorded:
        print(f"replay OK: {len(recorded)} action(s) reproduced exactly")
        return 0
    print(f"REPLAY DIVERGED: {len(recorded)} recorded vs {len(replayed)} replayed action(s)")
    for i, (a, b) in enumerate(zip(recorded, replayed)):
        if a != b:
            print(f"  first divergence at action #{i}:")
            print(f"    recorded: {json.dumps(a, sort_keys=True)}")
            print(f"    replayed: {json.dumps(b, sort_keys=True)}")
            break
    return 1


def _serve(argv):
    """``serve``: the always-on async serving loop behind ``POST
    /v1/completions`` (with ``"stream": true`` server-sent events),
    ``/healthz`` and ``/metrics``."""
    from deepspeed_tpu_torch.inference.serve import serve_main
    try:
        return serve_main(argv)
    except NotImplementedError as e:     # a setting outside the port: its ROADMAP item
        print(e, file=sys.stderr)
        return 2


def _not_ported(cmd):
    def run(argv):
        what, item = NOT_PORTED[cmd]
        from deepspeed_tpu_torch.utils.not_ported import not_ported
        try:
            not_ported(what, item)
        except NotImplementedError as e:
            print(e, file=sys.stderr)
        return 2
    return run


COMMANDS = {"health": health_cli, "top": top_cli, "ckpt": _ckpt, "trace": _trace, "ctl": _ctl,
            "serve": _serve,
            **{cmd: _not_ported(cmd) for cmd in NOT_PORTED}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("usage: python -m deepspeed_tpu_torch.cli {" + "|".join(COMMANDS) + "} [args...]")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; expected one of {sorted(COMMANDS)}")
        return 2
    rc = COMMANDS[cmd](argv[1:])
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())
