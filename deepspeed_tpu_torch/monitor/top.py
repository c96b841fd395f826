"""``cli top`` — the live operator dashboard over the telemetry plane (the
port of ``deepspeed_tpu/monitor/top.py``; run as ``python -m
deepspeed_tpu_torch.cli top``).

One refreshing terminal screen with serving panes (queue depth, running
rows, TTFT/TPOT/queue-wait percentiles, the request phase-ledger
breakdown from ``serving/phase_ms`` + wasted-token causes, KV pool +
host tier, prefix cache, SLO burn rates, the adaptive controller's knob
posture vs its config baseline with the last action + reason) and
training panes (loss EWMA, grad norm, tokens/s, MFU, fp16 skips), from
either of the plane's two surfaces:

- **scrape mode** — ``cli top http://host:port/metrics``: fetch the
  Prometheus exposition (a standalone :class:`MetricsExporter`, which
  ``telemetry.metrics_port`` starts beside a training engine), parse it back into a
  snapshot (``parse_prometheus_text``), render;
- **tail mode** — ``cli top telemetry.jsonl``: tail the sampler's (or
  the engine flush cadence's) JSONL time series, exactly like
  ``cli health`` but with the full pane set.

Rendering is :func:`~deepspeed_tpu_torch.monitor.health.health_summary` →
``render_summary_table`` — the same extraction ``cli health --json``
uses, so the screen, the JSON surface, and the scrape plane can never
drift apart. Part of the exposition plane: nothing here imports torch.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional, Tuple


def _desanitize(series: str) -> str:
    """Prometheus-sanitized series name → registry name: every metric in
    this repo is ``<layer>/<rest>`` with a slash-free first segment
    (``serving``, ``train``, ``slo``, ...), so the first underscore of
    the sanitized form maps back to the slash. Label blocks pass
    through untouched."""
    name, brace, labels = series.partition("{")
    return name.replace("_", "/", 1) + brace + labels


def snapshot_from_prometheus(text: str) -> Dict:
    """Parsed ``/metrics`` exposition as a registry-snapshot record
    (the shape ``health_summary`` consumes), series names de-sanitized
    back to their ``layer/name`` form."""
    from deepspeed_tpu_torch.monitor.metrics import parse_prometheus_text
    snap = parse_prometheus_text(text)
    return {"ts": time.time(),
            "counters": {_desanitize(k): v
                         for k, v in snap["counters"].items()},
            "gauges": {_desanitize(k): v
                       for k, v in snap["gauges"].items()},
            "histograms": {_desanitize(k): v
                           for k, v in snap["histograms"].items()}}


def fetch_snapshots(source: str, timeout: float = 5.0
                    ) -> Tuple[Optional[Dict], Optional[Dict]]:
    """(latest, previous) snapshot records from ``source`` — a
    ``/metrics`` URL (previous is None: the caller keeps scrape history)
    or a JSONL path. (None, None) when nothing is readable."""
    if source.startswith(("http://", "https://")):
        import urllib.request
        try:
            with urllib.request.urlopen(source, timeout=timeout) as resp:
                text = resp.read().decode("utf-8", "replace")
        except Exception:  # noqa: BLE001 — unreachable scrape = no data
            return None, None
        return snapshot_from_prometheus(text), None
    from deepspeed_tpu_torch.monitor.health import read_last_snapshots
    recs = read_last_snapshots(source, 2)
    if not recs:
        return None, None
    return recs[-1], (recs[-2] if len(recs) > 1 else None)


def render_top(rec: Optional[Dict], prev: Optional[Dict],
               source: str) -> str:
    from deepspeed_tpu_torch.monitor.health import (health_summary,
                                              render_summary_table)
    if rec is None:
        return (f"top: no data from {source}\n"
                "(scrape a /metrics URL — telemetry.metrics_port exposes one — "
                "or tail a sampler/telemetry JSONL)")
    head = f"source {source}"
    drop = (rec.get("gauges") or {}).get("events/dropped")
    if drop:
        head += f"   [flight recorder dropped {int(drop)}]"
    return head + "\n" + render_summary_table(health_summary(rec, prev))


def top_cli(argv=None) -> int:
    """``cli top <url-or-jsonl>`` — refreshing dashboard (``--once``
    renders a single screen; ``--json`` prints the summary dict)."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli top",
        description="live serving/training dashboard over a /metrics "
                    "URL or a telemetry JSONL")
    parser.add_argument("source",
                        help="http(s)://.../metrics to scrape, or a "
                             "JSONL telemetry/sampler sink to tail")
    parser.add_argument("--once", action="store_true",
                        help="render one screen and exit")
    parser.add_argument("--json", action="store_true",
                        help="print the latest health_summary as JSON "
                             "and exit")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds (default 2)")
    args = parser.parse_args(argv)

    if args.once or args.json:
        rec, prev = fetch_snapshots(args.source)
        if args.json:
            if rec is None:
                print(json.dumps({"error": "no data", "source": args.source}))
                return 1
            from deepspeed_tpu_torch.monitor.health import health_summary
            print(json.dumps(health_summary(rec, prev)))
            return 0
        print(render_top(rec, prev, args.source))
        return 0 if rec is not None else 1
    prev: Optional[Dict] = None
    try:
        while True:
            rec, tail_prev = fetch_snapshots(args.source)
            body = render_top(rec, tail_prev if tail_prev is not None
                              else prev, args.source)
            sys.stdout.write("\033[2J\033[H" + body + "\n")
            sys.stdout.flush()
            if rec is not None:
                prev = rec          # scrape mode: this screen is next
                # screen's rate base (tail mode reads its own history)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
