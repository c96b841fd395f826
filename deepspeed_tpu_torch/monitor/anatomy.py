"""Request latency anatomy: the per-request phase ledger, recomputed
from a flight-recorder event trace (the port of
``deepspeed_tpu/monitor/anatomy.py``).

``request_anatomy`` decomposes ONE request's end-to-end latency into the
same phases the live ledger books into ``serving/phase_ms`` — intake,
queue, prefill (incl. chunks + CoW), fetch (host-tier H2D), verify,
decode — plus a ``sched_wait`` remainder so the phases ALWAYS sum to the
end-to-end total exactly.  ``trace_anatomy`` groups every request
carrying one causal trace id (a disaggregated prefill→decode pair plus
any failover replays) and adds the cross-replica ``handoff`` phase from
the router's ``serve.handoff`` marker.

Everything here is a pure function of the event list: feed it a
recorder ``snapshot()`` or re-parsed ``write_jsonl`` lines and the
decomposition is replay-identical — no wall clock, no recorder access,
no torch.  ``cli trace <request-id>`` and the tests render from these
functions so screen / JSON / scrape cannot drift.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

#: ledger phases, in anatomy order.  ``sched_wait`` is the remainder
#: (total minus everything attributable), clamped at zero — it absorbs
#: scheduler bookkeeping, host-side sampling, and inter-tick idle time.
PHASES = ("intake", "queue", "prefill", "fetch", "verify", "decode",
          "sched_wait")

_END_KINDS = ("req.retire", "req.cancel", "req.timeout", "req.shed")
_PREFILL_KINDS = ("req.prefill", "req.prefill_chunk", "req.cow_copy")


def _norm(e: Any) -> Tuple[int, str, Optional[int], int, Dict[str, Any]]:
    """Normalize one event — a frozen ``Event`` or a flattened JSONL
    dict — to ``(ts_ns, kind, rid, dur_ns, extras)``."""
    if isinstance(e, dict):
        extras = {k: v for k, v in e.items()
                  if k not in ("ts_ns", "kind", "rid", "step", "dur_ns")}
        return (int(e.get("ts_ns", 0)), str(e.get("kind", "")),
                e.get("rid"), int(e.get("dur_ns") or 0), extras)
    return (e.ts_ns, e.kind, e.rid, e.dur_ns or 0, dict(e.data or {}))


def request_anatomy(events: Iterable[Any], rid: int,
                    replica: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
    """Decompose request ``rid``'s latency from its event trace.

    Returns ``None`` when the trace never mentions the rid.  The result
    dict carries ``phases_ms`` (every :data:`PHASES` key, summing to
    ``total_ms`` exactly), ``ttft_ms`` (intake + queue + prefill + fetch
    + first decode tick), ``total_ms``, per-phase event counts, the
    propagated ``trace``/``parent`` context and ``replica`` tag from
    ``req.enqueue``, and the terminal ``outcome`` (``retire`` | ``cancel``
    | ``timeout`` | ``shed`` | ``running`` for an unfinished trace).

    Rids are PER-ENGINE counters, so a fleet-merged trace usually holds
    the same rid on several replicas: pass ``replica`` to scope the
    decomposition to one replica's events (events carrying no replica
    tag match the default ``"r0"``)."""
    rid = int(rid)
    want_rep = None if replica is None else str(replica)
    submit_ts = enqueue_ts = admit_ts = end_ts = None
    last_ts = None
    outcome = "running"
    trace = parent = replica = None
    generated = None
    phase_ns = {p: 0 for p in PHASES}
    counts = {p: 0 for p in PHASES}
    explicit = set()           # phases covered by req.phase ledger events
    first_decode_ns = None
    seen = False
    for raw in events:
        ts, kind, erid, dur, d = _norm(raw)
        if want_rep is not None and d.get("replica", "r0") != want_rep:
            continue
        if kind == "decode.tick":
            if rid in (d.get("rids") or ()):
                seen = True
                phase_ns["decode"] += dur
                counts["decode"] += 1
                if first_decode_ns is None:
                    first_decode_ns = dur
                last_ts = max(last_ts or 0, ts + dur)
            continue
        if erid != rid:
            continue
        seen = True
        last_ts = max(last_ts or 0, ts + dur)
        if kind == "req.submit":
            submit_ts = ts
        elif kind == "req.enqueue":
            enqueue_ts = ts
            trace = d.get("trace", trace)
            parent = d.get("parent", parent)
            replica = d.get("replica", replica)
        elif kind == "req.admit":
            if admit_ts is None:
                admit_ts = ts
        elif kind == "req.phase":
            p = d.get("phase")
            if p in phase_ns:
                phase_ns[p] += dur
                counts[p] += 1
                explicit.add(p)
        elif kind in _PREFILL_KINDS:
            phase_ns["prefill"] += dur
            counts["prefill"] += 1
        elif kind == "kv.fetch":
            phase_ns["fetch"] += dur
            counts["fetch"] += 1
        elif kind == "req.spec_verify":
            phase_ns["verify"] += dur
            counts["verify"] += 1
        elif kind in _END_KINDS:
            end_ts = ts
            outcome = kind.split(".", 1)[1]
            if "generated" in d:
                generated = d["generated"]
    if not seen:
        return None
    # pre-admission phases: the req.phase ledger events are authoritative
    # (emitted from the scheduler's own clocks); reconstruct from the
    # submit/enqueue/admit timestamps only when they are absent
    if "intake" not in explicit and submit_ts is not None \
            and enqueue_ts is not None:
        phase_ns["intake"] = max(enqueue_ts - submit_ts, 0)
    if "queue" not in explicit and enqueue_ts is not None \
            and admit_ts is not None:
        phase_ns["queue"] = max(admit_ts - enqueue_ts, 0)
    start_ts = submit_ts if submit_ts is not None else enqueue_ts
    stop_ts = end_ts if end_ts is not None else last_ts
    total_ns = max((stop_ts or 0) - (start_ts or 0), 0) \
        if start_ts is not None else sum(phase_ns.values())
    attributed = sum(v for p, v in phase_ns.items() if p != "sched_wait")
    if total_ns < attributed:
        # clock-skew guard (phase durs come from monotonic_ns, the
        # boundaries from emit timestamps): never report negative wait
        total_ns = attributed
    phase_ns["sched_wait"] = total_ns - attributed
    ttft_ns = (phase_ns["intake"] + phase_ns["queue"]
               + phase_ns["prefill"] + phase_ns["fetch"]
               + (first_decode_ns or 0))
    return {
        "rid": rid, "trace": trace, "parent": parent, "replica": replica,
        "outcome": outcome, "generated": generated,
        "phases_ms": {p: phase_ns[p] / 1e6 for p in PHASES},
        "counts": counts,
        "total_ms": total_ns / 1e6,
        "ttft_ms": ttft_ns / 1e6,
    }


def trace_anatomy(events: Iterable[Any],
                  trace: str) -> Optional[Dict[str, Any]]:
    """Anatomy of one CAUSAL trace id across the fleet: every request
    enqueued with ``trace=`` (prefill warm-up, decode continuation,
    failover replays), ordered by enqueue time, plus the router's
    ``handoff_ms`` (``serve.handoff`` marks completion; the phase wall
    time lives on the prefill replica's ledger).  Returns ``None`` for
    an unknown trace id."""
    trace = str(trace)
    events = list(events)
    # (enqueue ts, rid, replica): rids are per-engine counters, so legs
    # are identified by the (replica, rid) PAIR, never the rid alone
    rids: List[Tuple[int, int, str]] = []
    handoffs: List[Dict[str, Any]] = []
    for raw in events:
        ts, kind, rid, _dur, d = _norm(raw)
        if kind == "req.enqueue" and d.get("trace") == trace \
                and rid is not None:
            rids.append((ts, int(rid), str(d.get("replica", "r0"))))
        elif kind == "serve.handoff" and d.get("trace") == trace:
            handoffs.append({"from": d.get("from_replica"),
                             "to": d.get("to_replica"), "rid": rid})
    if not rids:
        return None
    rids.sort()
    legs = [request_anatomy(events, r, replica=rep) for _, r, rep in rids]
    legs = [a for a in legs if a is not None]
    return {
        "trace": trace,
        "legs": legs,
        "handoffs": handoffs,
        "total_ms": sum(a["total_ms"] for a in legs),
    }


def resolve_request_id(request_id) -> Tuple[Optional[str], Optional[int]]:
    """CLI convenience: map a user-supplied request id — an integer rid
    or a ``t<seq>`` trace id — to ``(trace, rid)`` (exactly one set)."""
    s = str(request_id)
    try:
        return None, int(s)
    except ValueError:
        return s, None


def format_anatomy(a: Dict[str, Any]) -> str:
    """Render one request's anatomy for ``cli trace`` — a fixed-width
    phase table plus the TTFT/outcome summary line."""
    lines = []
    head = f"request {a['rid']}"
    if a.get("replica"):
        head += f" @ {a['replica']}"
    if a.get("trace"):
        head += f"  trace={a['trace']}"
    if a.get("parent") is not None:
        head += f" parent={a['parent']}"
    lines.append(head)
    total = a["total_ms"] or 1e-9
    for p in PHASES:
        ms = a["phases_ms"][p]
        n = a["counts"].get(p, 0)
        bar = "#" * min(int(round(40 * ms / total)), 40)
        ev = f" ({n} ev)" if n else ""
        lines.append(f"  {p:<10} {ms:>10.3f} ms  {bar}{ev}")
    lines.append(f"  {'total':<10} {a['total_ms']:>10.3f} ms   "
                 f"ttft={a['ttft_ms']:.3f} ms  outcome={a['outcome']}"
                 + (f"  generated={a['generated']}"
                    if a.get("generated") is not None else ""))
    return "\n".join(lines)


def format_trace_anatomy(t: Dict[str, Any]) -> str:
    """Render a fleet trace id's anatomy: one block per leg, joined by
    the handoff hops."""
    lines = [f"trace {t['trace']}: {len(t['legs'])} leg(s), "
             f"{t['total_ms']:.3f} ms total"]
    for hop in t["handoffs"]:
        lines.append(f"  handoff: {hop['from']} -> {hop['to']} "
                     f"(prefill rid {hop['rid']})")
    for a in t["legs"]:
        lines.append("")
        lines.append(format_anatomy(a))
    return "\n".join(lines)
