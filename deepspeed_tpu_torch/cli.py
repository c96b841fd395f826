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
  stand the control plane up beside it; ``--replicas N`` and
  ``--replica-roles`` put N engines behind the replica router)
- ``profile <trace.json | dir> [--top N]`` — per-span statistics of a
  chrome trace, or of each ``trace_<n>.json`` a ``ProfileWindow``
  (``engine.profile(steps=N)``, ``telemetry.profile``) wrote into a directory

- ``report [--telemetry <jsonl>]`` — the environment report (``env_report.py``):
  the kernel libraries built, torch / CUDA / nvcc versions, the devices
- ``elastic <config> [-w N]`` — the elastic batch-size plan of a config's
  ``elasticity`` section (``elasticity/``)
- ``autotune <config> [--model m] [--seq-len S] [--device d]`` — the config
  search of ``autotuning/``; writes ``ds_config_optimal.json`` into the
  section's ``results_dir``

- ``run [--num_gpus N] [-H hostfile] ... <script> [args...]`` — the launcher
  (``launcher/runner.py``): one rank a GPU, locally or over the hostfile's
  nodes (pdsh, OpenMPI, MPICH, MVAPICH, Intel MPI, SLURM)
- ``bench [--minsize B] [--maxsize B] [--ops ...] [--device cuda|cpu]`` — the
  collective micro-benchmarks (``benchmarks/comm_bench.py``)
- ``ssh [-f hostfile] <command>`` — run a shell command on every hostfile
  host over pdsh

``lint`` is not ported: it prints the refusal naming its ROADMAP.md item
and returns 2. Nothing here imports torch until a command that needs it
runs.
"""

from __future__ import annotations

import os
import sys


#: the JAX package's subcommands the port does not have yet, with the
#: ROADMAP.md item that brings each
NOT_PORTED = {
    "lint": ("the trace-safety analyzer (dscli lint)", "queue 1: tools/dslint for the port"),
}


def _health(argv):
    from deepspeed_tpu_torch.monitor.health import health_cli
    return health_cli(argv)


def _top(argv):
    from deepspeed_tpu_torch.monitor.top import top_cli
    return top_cli(argv)


def _run(argv):
    from deepspeed_tpu_torch.launcher import runner
    runner.main(argv)


def _bench(argv):
    from deepspeed_tpu_torch.benchmarks.comm_bench import main as bench_main
    bench_main(argv)


def _ssh(argv):
    """Run a shell command on every hostfile host over pdsh (the
    reference's ``ds_ssh``)."""
    import argparse
    import shutil
    import subprocess

    from deepspeed_tpu_torch.launcher.runner import DLTS_HOSTFILE, fetch_hostfile

    parser = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.cli ssh",
                                     description="run a command on all hosts")
    parser.add_argument("-f", "--hostfile", type=str, default=None,
                        help=f"hostfile path (default {DLTS_HOSTFILE})")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run on every host")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if shutil.which("pdsh") is None:
        raise RuntimeError("cannot find pdsh; install it (apt-get install pdsh)")
    resources = fetch_hostfile(args.hostfile or DLTS_HOSTFILE)
    if not resources:
        raise RuntimeError(f"missing or empty hostfile {args.hostfile or DLTS_HOSTFILE}")
    env = dict(os.environ, PDSH_RCMD_TYPE="ssh")
    return subprocess.call(["pdsh", "-w", ",".join(resources)] + args.command, env=env)


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


def _span_table(path, top):
    """The chrome-trace branch of the JAX ``_profile`` (``cli.py:310``):
    per-name statistics of the complete (``ph == "X"``) spans, ranked by
    total time. Returns the exit code."""
    import json

    try:
        with open(path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents", [])
    except ValueError:
        print(f"{path}: not JSON (pass a chrome-trace .json or a ProfileWindow "
              "directory)")
        return 1
    spans = {}
    for ev in events:
        if ev.get("ph") == "X" and isinstance(ev.get("dur"), (int, float)):
            s = spans.setdefault(ev.get("name", "?"), {"n": 0, "total_us": 0.0, "max_us": 0.0})
            s["n"] += 1
            s["total_us"] += ev["dur"]
            s["max_us"] = max(s["max_us"], ev["dur"])
    if not spans:
        print(f"{path}: no complete (ph=X) spans")
        return 1
    print(f"{path}: {sum(s['n'] for s in spans.values())} spans, {len(spans)} names")
    print(f"{'name':<32} {'count':>7} {'total ms':>10} {'mean ms':>9} {'max ms':>9}")
    ranked = sorted(spans.items(), key=lambda kv: -kv[1]["total_us"])
    for name, s in ranked[:top]:
        print(f"{name[:32]:<32} {s['n']:>7} {s['total_us'] / 1e3:>10.2f} "
              f"{s['total_us'] / s['n'] / 1e3:>9.3f} {s['max_us'] / 1e3:>9.3f}")
    if len(ranked) > top:
        print(f"... {len(ranked) - top} more (raise --top)")
    return 0


def _profile(argv):
    """``profile <path>``: a chrome-trace JSON (``export_serving_trace``,
    ``export_fleet_trace``, a step tracer's export) gets the JAX
    ``_profile``'s span table; a directory gets one table per
    ``trace_<n>.json`` that ``ProfileWindow`` wrote there (the port's
    ``torch.profiler`` captures, in place of a ``jax.profiler`` logdir).
    rc 1 when there is nothing to summarize."""
    import argparse
    import re

    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli profile",
        description="summarize a ProfileWindow directory or a chrome-trace JSON")
    parser.add_argument("path", help="ProfileWindow directory or trace .json")
    parser.add_argument("--top", type=int, default=20,
                        help="spans to show for a chrome trace (default 20)")
    args = parser.parse_args(argv)
    path = os.path.abspath(args.path)
    if os.path.isfile(path):
        return _span_table(path, args.top)
    if not os.path.isdir(path):
        print(f"{path}: no such file or directory")
        return 1
    found = [(int(m.group(1)), name) for name in os.listdir(path)
             for m in [re.fullmatch(r"trace_(\d+)\.json", name)] if m]
    if not found:
        print(f"{path}: no trace_<n>.json captures: take one with "
              "engine.profile(steps=N) or telemetry.profile")
        return 1
    print(f"{path}: {len(found)} capture(s)")
    rc = 0
    for _, name in sorted(found):
        rc = max(rc, _span_table(os.path.join(path, name), args.top))
    return rc


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
    except ValueError as e:              # a model the loop cannot serve (an encoder)
        print(e, file=sys.stderr)
        return 2


def _report(argv):
    """``report``: the environment / kernel-library / device-memory report."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.cli report",
                                     description="environment / kernel / device-memory report")
    parser.add_argument("--telemetry", type=str, default=None,
                        help="JSONL telemetry sink path; also prints the latest snapshot summary")
    args = parser.parse_args(argv)
    from deepspeed_tpu_torch import env_report
    env_report.main(telemetry_path=args.telemetry)
    return 0


def _elastic(argv):
    """``elastic <config>``: the valid world sizes and the batch of a
    config's elastic plan, or at ``-w N`` the batch, micro-batch and
    accumulation steps for that world size."""
    import argparse
    import json

    from deepspeed_tpu_torch.elasticity import compute_elastic_config

    parser = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.cli elastic",
                                     description="elastic batch-size planner")
    parser.add_argument("config", type=str, help="ds_config json path")
    parser.add_argument("-w", "--world-size", type=int, default=0)
    args = parser.parse_args(argv)
    with open(args.config) as fd:
        ds_config = json.load(fd)
    if args.world_size:
        batch, micro, gas = compute_elastic_config(ds_config, world_size=args.world_size)
        print(f"world_size={args.world_size}: train_batch={batch}, "
              f"micro_batch={micro}, gradient_accumulation_steps={gas}")
    else:
        batch, valid_worlds = compute_elastic_config(ds_config)
        print(f"valid world sizes: {valid_worlds}")
        print(f"max train_batch:   {batch}")
    return 0


def _autotune(argv):
    """``autotune <config>``: search zero stage x micro-batch x remat x
    loss chunk for a zoo preset (reference ``deepspeed --autotuning``) and
    print the optimal config."""
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli autotune",
        description="search zero stage x micro-batch x remat x loss-chunk "
                    "(reference: deepspeed --autotuning)")
    parser.add_argument("config", type=str, help="ds_config json path")
    parser.add_argument("--model", type=str, default="gpt2:125m",
                        help="model zoo preset, e.g. gpt2:125m, llama:tiny")
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="where the trials run (default cuda:0; cpu runs the plain kernels)")
    args = parser.parse_args(argv)

    from deepspeed_tpu_torch.autotuning import Autotuner
    from deepspeed_tpu_torch.models.presets import get_model

    with open(args.config) as fd:
        ds_config = json.load(fd)
    name, _, size = args.model.partition(":")
    model = get_model(name, *([size] if size else []))
    best = Autotuner(model, base_config=ds_config, seq_len=args.seq_len,
                     device=args.device).tune()
    print(json.dumps(best, indent=2))
    return 0


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


COMMANDS = {"run": _run, "health": _health, "top": _top, "bench": _bench, "ckpt": _ckpt,
            "trace": _trace, "ctl": _ctl, "serve": _serve, "profile": _profile,
            "report": _report, "elastic": _elastic, "autotune": _autotune, "ssh": _ssh,
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
