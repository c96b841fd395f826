"""Flight recorder: a typed, bounded, thread-safe ring of lifecycle events
(a copy of ``deepspeed_tpu/monitor/events.py``, standard library only: the
same event kinds, payloads and chrome-trace shapes, so a trace from either
package reads the same).

The metrics registry is *aggregate* observability; this module records
*what happened when*: a ring buffer of
structured events with monotonic-ns timestamps and request/step identity,
emitted by the training engine (step / phase / checkpoint phases / fp16
skip), the continuous-batching scheduler (enqueue / admit / cache hit /
preempt / retire / cancel, speculative propose / rollback), the inference
engine (prefill, prefill chunk, COW copy, fused decode tick, speculative
verify, tiered-KV spill / fetch), the async serving front-end (submit /
drain, step-fault containment / engine restart / request requeue /
timeout / shed), the burn-rate SLO engine (breach), and the crash-safe
checkpoint writer (snapshot / serialize / commit / retry). The buffer keeps the newest
``capacity`` events (a flight recorder preserves the TAIL — the moments
before the incident), counting evictions in ``dropped``.

Cost discipline: when disabled, every emit site gates at ONE flag/None
check and allocates nothing (the engines hold ``None`` instead of the
recorder on their hot paths; :meth:`FlightRecorder.emit` itself returns
after one flag check for the module-level sites like the checkpoint
writer). Enabled, an emit is one :class:`Event` allocation and a locked
deque append — host-side work on paths that already do host-side
bookkeeping, never inside compiled code.

Two export shapes:

- :meth:`FlightRecorder.write_jsonl` — the raw timeline, one event per
  line. Anomaly debug bundles and the SIGTERM/emergency-save path ship
  this as ``events.jsonl`` so every post-mortem carries its timeline.
- :func:`export_serving_trace` — the serving events rendered as
  chrome-trace JSON (Perfetto / chrome://tracing): one track per request
  holding its admission→retire span with prefill/decode/preempt child
  events, plus queue-depth and KV-block counter tracks.
- :func:`export_fleet_trace` — the replica fleet's merged timeline: one
  track group per replica (events tagged by :class:`TaggedRecorder`),
  the router's decision track, and ``ph:"s"``/``ph:"f"`` flow arrows
  stitching the disaggregated prefill→decode handoff across replicas.

All are schema-checked by ``tools/validate_trace.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

#: the typed event catalogue — ``emit`` rejects anything else, so the
#: exporters and the schema validator can rely on the vocabulary.
EVENT_KINDS = frozenset({
    # training engine
    "train.step",           # one train_batch (step=, dur_ns=)
    "train.phase",          # trio phase (step=, dur_ns=, phase=fwd|bwd|step)
    "train.fp16_skip",      # overflow skipped the update (step=)
    # checkpoint (crash-safe two-phase path)
    "ckpt.snapshot",        # device->host snapshot (step=, dur_ns=, tag=)
    "ckpt.serialize",       # npz+manifest write+fsync (dur_ns=, tag=)
    "ckpt.commit",          # atomic rename + dir fsync (dur_ns=, tag=, bytes=)
    "ckpt.retry",           # transient I/O fault retried (what=, attempt=, error=)
    # serving: scheduler state machine (rid= identity)
    "req.submit",           # async front-end accepted a submission
    #                         (prompt_tokens=, priority=; ts = caller-side
    #                         submit time, may precede ring neighbors)
    "req.enqueue",          # add_request (prompt_tokens=, max_new=)
    "req.admit",            # admission (cached_tokens=, blocks=)
    "req.cancel",           # cancellation retired the request (generated=)
    "req.cache_hit",        # admission prefix-cache probe hit (tokens=)
    "req.cache_miss",       # admission prefix-cache probe miss
    "req.preempt",          # recompute-preemption (blocks=, recompute_tokens=)
    "req.retire",           # finished (generated=, error=)
    # serving: engine compute steps (dur_ns= brackets the device work)
    "req.prefill",          # whole-prompt prefill (tokens=)
    "req.prefill_chunk",    # one prefill chunk (start=, tokens=)
    "req.cow_copy",         # copy-on-write block split (src=, dst=)
    "decode.tick",          # one fused decode step (rids=, n=)
    # serving: speculative decoding (n-gram self-speculation)
    "req.spec_propose",     # host n-gram proposal (tokens=, found=)
    "req.spec_verify",      # fused verify step slice (window=, accepted=)
    "req.spec_rollback",    # rejection rewound pos (rejected=, unregistered=)
    # serving: tiered KV cache (host-RAM spill pool)
    "kv.spill",             # cold block demoted D2H (blocks=, bytes=,
    #                         block=; dur_ns brackets the gather dispatch +
    #                         async-copy kick-off)
    "kv.fetch",             # host hit re-materialized H2D into the rid's
    #                         fresh blocks (blocks=, bytes=; dur_ns
    #                         brackets the synced scatters)
    "serve.begin",          # generate_batch / async-loop entry (requests=)
    "serve.end",            # serve span (dur_ns=, requests=)
    "serve.drain",          # async loop stopped intake (waiting=,
    #                         running=, pending=; router-level drains add
    #                         replica= — the breaker-tripped source being
    #                         drained to siblings)
    "serve.route",          # replica router decision (seq=, replica=,
    #                         reason= affinity | least_loaded | failover |
    #                         handoff | prefill, session=)
    # serving fault tolerance (serving.fault)
    "serve.fault",          # an engine-step exception was contained
    #                         (action= dispatch site, error=)
    "serve.restart",        # crash-safe engine recovery: pools + jits
    #                         rebuilt, in-flight re-admitted (restart=,
    #                         error=)
    "req.requeue",          # per-request fault retry: re-queued through
    #                         recompute-preemption with logical-step
    #                         backoff (retry=, backoff_steps=, error=)
    "req.timeout",          # deadline expiry retired the request
    #                         (generated=, error=)
    "req.shed",             # load shedding dropped a queued request
    #                         (priority=)
    "serve.handoff",        # disaggregated prefill->decode transfer
    #                         completed: the prefill replica demoted the
    #                         chain to the host tier and the decode
    #                         sibling resubmitted (trace=, from_replica=,
    #                         to_replica=; rid = the prefill-side rid)
    # request latency anatomy (phase ledger)
    "req.phase",            # one phase of a request's latency anatomy
    #                         (phase= intake | queue | ..., dur_ns= the
    #                         phase duration — an already-elapsed
    #                         interval ENDING at ts, unlike the timed
    #                         compute spans above)
    # scheduler occupancy sample (the counter-track source)
    "sched.gauge",          # queued=, running=, kv_used=, kv_free=
    # SLO engine (monitor/slo.py): a burn-rate alert fired
    "slo.breach",           # objective=, tick=, burn_rate=, threshold=,
    #                         window= (the longest evaluation window —
    #                         also the refire period)
    # adaptive controller decision ledger (monitor/controller.py):
    # observation -> decision -> application, replayable end to end
    "ctl.observe",          # one folded sampler-tick observation (tick=,
    #                         ttft_burn=, tpot_burn=, goodput_burn=,
    #                         queue_depth=, kv_util=, spec_acceptance=,
    #                         ...; the FIRST entry also carries config=
    #                         the ladder/threshold manifest replay seeds
    #                         from)
    "ctl.decide",           # one knob movement decided (tick=, knob=,
    #                         direction= tighten | relax, value=, prev=,
    #                         reason=, at_baseline=)
    "ctl.apply",            # serving thread applied the movement between
    #                         engine steps (knob=, value=, prev=, tick=,
    #                         reason=; restart=True when re-applied from
    #                         the ledger after an engine restart)
    "ctl.revert",           # a relax landed the knob back on its config
    #                         baseline (same payload as ctl.apply)
})


@dataclasses.dataclass(frozen=True)
class Event:
    """One flight-recorder entry. ``ts_ns`` is ``time.monotonic_ns()`` at
    the event's START (timed events pass their start explicitly so the
    slice covers [ts_ns, ts_ns + dur_ns]); ``rid``/``step`` carry request
    or training-step identity; ``data`` the kind-specific payload."""
    ts_ns: int
    kind: str
    rid: Optional[int] = None
    step: Optional[int] = None
    dur_ns: Optional[int] = None
    data: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"ts_ns": self.ts_ns, "kind": self.kind}
        if self.rid is not None:
            d["rid"] = self.rid
        if self.step is not None:
            d["step"] = self.step
        if self.dur_ns is not None:
            d["dur_ns"] = self.dur_ns
        if self.data:
            d.update(self.data)
        return d


class FlightRecorder:
    """Bounded ring of :class:`Event`. Oldest events are evicted when the
    ring is full (``dropped`` counts them); ``snapshot()`` returns the
    retained tail oldest-first. Thread-safe: scheduler/engine emits land
    from the caller thread, checkpoint emits from the writer thread."""

    DEFAULT_CAPACITY = 16384

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._dropped = 0
        self.enabled = enabled

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def enable(self, capacity: Optional[int] = None) -> "FlightRecorder":
        """Turn recording on, optionally resizing the ring (a resize keeps
        the newest events that still fit)."""
        with self._lock:
            if capacity is not None and capacity != self._buf.maxlen:
                if capacity < 1:
                    raise ValueError("capacity must be >= 1")
                self._buf = deque(self._buf, maxlen=capacity)
            self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def emit(self, kind: str, rid: Optional[int] = None,
             step: Optional[int] = None, dur_ns: Optional[int] = None,
             t_ns: Optional[int] = None, **data) -> None:
        """Record one event. Disabled-mode cost is this method's first
        flag check (hot paths gate even earlier by holding ``None``).
        ``t_ns`` overrides the start timestamp for timed events whose
        duration was measured before emitting."""
        if not self.enabled:
            return
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r} "
                             "(see monitor.events.EVENT_KINDS)")
        ev = Event(ts_ns=t_ns if t_ns is not None else time.monotonic_ns(),
                   kind=kind, rid=rid, step=step, dur_ns=dur_ns,
                   data=data or None)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(ev)

    def snapshot(self) -> List[Event]:
        """The retained events, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def write_jsonl(self, path: str) -> str:
        """Dump the retained tail as JSONL (one event dict per line,
        oldest first); returns the path. The schema is what
        ``tools/validate_trace.py --kind events`` checks."""
        events = self.snapshot()
        dropped = self.dropped
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            if dropped:
                f.write(json.dumps({"ts_ns": events[0].ts_ns if events else 0,
                                    "kind": "recorder.dropped",
                                    "count": dropped}) + "\n")
            for ev in events:
                f.write(json.dumps(ev.to_dict()) + "\n")
        return path


# ------------------------------------------------------------------ #
# process-global recorder (the engines all share one timeline, so a merged
# post-mortem interleaves training, checkpoint, and serving events)

_recorder: Optional[FlightRecorder] = None
_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


class TaggedRecorder:
    """Replica-tagging emit proxy over a (shared) :class:`FlightRecorder`.

    Every in-process replica records into the ONE global ring (so a merged
    post-mortem interleaves the whole fleet), which means the ring itself
    cannot say which replica an event came from. Each engine therefore
    wraps the shared recorder in its own ``TaggedRecorder``: ``emit``
    stamps ``replica=<name>`` into the payload (``setdefault`` — emit
    sites that name a replica explicitly, like router drains, win), and
    the fleet renderer groups tracks by that tag. ``replica`` is mutable:
    the router renames engines after construction and the schedulers
    holding this wrapper pick the new tag up on their next emit.

    Everything else (``snapshot``/``clear``/``enable``/``write_jsonl``/
    ``dropped``/...) proxies to the wrapped recorder, so existing callers
    cannot tell the difference."""

    def __init__(self, recorder: FlightRecorder, replica: str = "r0"):
        self._recorder = recorder
        self.replica = replica

    def emit(self, kind: str, rid: Optional[int] = None,
             step: Optional[int] = None, dur_ns: Optional[int] = None,
             t_ns: Optional[int] = None, **data) -> None:
        if not self._recorder.enabled:
            return
        data.setdefault("replica", self.replica)
        self._recorder.emit(kind, rid=rid, step=step, dur_ns=dur_ns,
                            t_ns=t_ns, **data)

    def __len__(self) -> int:
        return len(self._recorder)

    def __getattr__(self, name):
        return getattr(self._recorder, name)


def export_recorder_metrics(registry=None,
                            recorder: Optional[FlightRecorder] = None
                            ) -> None:
    """Publish the recorder's ring health as ``events/dropped`` /
    ``events/capacity`` gauges so silent trace loss is visible on the
    ``/metrics`` plane (a post-mortem that trusts a ring which quietly
    evicted its incident is worse than no ring). Called by the exporter
    on every scrape and by the sampler on every tick; a disabled
    recorder exports nothing (nothing is being lost — it records
    nothing by design)."""
    rec = recorder if recorder is not None else get_flight_recorder()
    if not rec.enabled:
        return
    if registry is None:
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        registry = get_registry()
    registry.gauge(
        "events/capacity",
        "flight-recorder ring size (events retained before eviction)"
    ).set(rec.capacity)
    registry.gauge(
        "events/dropped",
        "flight-recorder events evicted since enable/clear — nonzero "
        "means the trace tail no longer reaches back to the incident"
    ).set(rec.dropped)


# ------------------------------------------------------------------ #
# serving trace rendering: chrome-trace JSON, one track per request

_SERVING_PID = 1      # per-request tracks
_ENGINE_PID = 2       # engine spans + counter tracks
_ENGINE_TID = 0

#: request-track child slices: recorder kind -> slice name
_CHILD_SLICES = {"req.prefill": "prefill", "req.prefill_chunk": "prefill_chunk",
                 "req.cow_copy": "cow_copy",
                 "req.spec_propose": "spec_propose",
                 "req.spec_verify": "spec_verify",
                 "kv.fetch": "kv_fetch"}
#: request-track instants
_INSTANTS = {"req.enqueue": "enqueue", "req.submit": "submit",
             "req.cache_hit": "cache_hit",
             "req.cache_miss": "cache_miss", "req.preempt": "preempt",
             "req.cancel": "cancel",
             "req.spec_rollback": "spec_rollback",
             "req.requeue": "requeue", "req.timeout": "timeout",
             "req.shed": "shed"}
#: retirement-flavored kinds: each CLOSES its request's span (a timed-out
#: or shed request's lifetime ends there, exactly like cancel)
_SPAN_CLOSERS = ("req.retire", "req.cancel", "req.timeout", "req.shed")


def render_serving_trace(events: Iterable[Event], *,
                         t0_ns: Optional[int] = None,
                         serving_pid: int = _SERVING_PID,
                         engine_pid: int = _ENGINE_PID,
                         name_prefix: str = "") -> Dict[str, Any]:
    """Render serving events as a chrome-trace document: per-request
    tracks (pid 1, tid = rid) each holding exactly ONE admission→retire
    span (first admission to final retirement — a preempted-and-resumed
    request stays one span, with its preemption as an instant inside)
    with prefill / prefill-chunk / decode-tick / COW child slices, plus
    ``queue_depth`` and ``kv_blocks`` counter tracks and the
    ``generate_batch`` engine spans (pid 2).

    The keyword overrides exist for :func:`render_fleet_trace`, which
    renders each replica's slice of the shared ring as its own process
    pair on ONE timeline: a shared ``t0_ns`` epoch, per-replica pids,
    and a ``name_prefix`` distinguishing the track groups. Defaults
    reproduce the single-replica document exactly."""
    events = [e for e in events
              if e.kind.startswith(("req.", "serve.", "decode.", "sched.",
                                    "kv.", "slo.", "ctl."))]
    out: List[Dict[str, Any]] = []
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t0 = t0_ns if t0_ns is not None else min(e.ts_ns for e in events)

    def us(ts_ns: int) -> float:
        return (ts_ns - t0) / 1e3

    # ---- per-request lifecycle ---- #
    admits: Dict[int, int] = {}            # rid -> first admission ts
    last_seen: Dict[int, int] = {}         # rid -> newest event end ts
    retires: Dict[int, Event] = {}
    info: Dict[int, Dict[str, Any]] = {}
    for e in events:
        rid = e.rid
        if rid is None and e.kind == "decode.tick":
            end = e.ts_ns + (e.dur_ns or 0)
            for r in (e.data or {}).get("rids", ()):  # fused over many reqs
                last_seen[r] = max(last_seen.get(r, 0), end)
            continue
        if rid is None:
            continue
        # req.phase durations are already-elapsed intervals ENDING at ts
        # (a queue wait reported at admission), so they must not push the
        # request's observed end forward
        last_seen[rid] = max(last_seen.get(rid, 0),
                             e.ts_ns + (0 if e.kind == "req.phase"
                                        else (e.dur_ns or 0)))
        meta = info.setdefault(rid, {"preemptions": 0, "cached_tokens": 0})
        if e.kind == "req.admit":
            admits.setdefault(rid, e.ts_ns)
            meta["cached_tokens"] += (e.data or {}).get("cached_tokens", 0)
        elif e.kind == "req.enqueue":
            meta["prompt_tokens"] = (e.data or {}).get("prompt_tokens")
        elif e.kind == "req.preempt":
            meta["preemptions"] += 1
        elif e.kind in _SPAN_CLOSERS:
            # cancellation / timeout / shed end the request's lifetime
            # exactly like a retirement: the span closes at that instant
            retires[rid] = e
            if e.kind == "req.cancel":
                meta["cancelled"] = True
            elif e.kind == "req.timeout":
                meta["timed_out"] = True
            elif e.kind == "req.shed":
                meta["shed"] = True

    for rid in sorted(admits):
        out.append({"ph": "M", "name": "thread_name", "pid": serving_pid,
                    "tid": rid, "args": {"name": f"{name_prefix}req {rid}"}})
        start = admits[rid]
        ret = retires.get(rid)
        end = ret.ts_ns if ret is not None else last_seen[rid]
        args = {k: v for k, v in info[rid].items() if v is not None}
        if ret is not None:
            args.update({k: v for k, v in (ret.data or {}).items()
                         if v is not None})
        else:
            args["incomplete"] = True      # truncated ring / still running
        out.append({"name": f"request {rid}", "cat": "request", "ph": "X",
                    "pid": serving_pid, "tid": rid, "ts": us(start),
                    "dur": max((end - start) / 1e3, 0.001), "args": args})

    # ---- child slices, instants, counters, engine spans ---- #
    for e in events:
        if e.kind in _CHILD_SLICES:
            out.append({"name": _CHILD_SLICES[e.kind], "cat": "serving",
                        "ph": "X", "pid": serving_pid, "tid": e.rid,
                        "ts": us(e.ts_ns), "dur": (e.dur_ns or 0) / 1e3,
                        "args": dict(e.data or {})})
        elif e.kind in _INSTANTS:
            if e.rid is None:
                # no request track to pin it to (e.g. an intake-deadline
                # timeout that never reached the scheduler): engine track
                out.append({"name": _INSTANTS[e.kind], "cat": "serving",
                            "ph": "i", "s": "p", "pid": engine_pid,
                            "tid": _ENGINE_TID, "ts": us(e.ts_ns),
                            "args": dict(e.data or {})})
                continue
            out.append({"name": _INSTANTS[e.kind], "cat": "serving",
                        "ph": "i", "s": "t", "pid": serving_pid,
                        "tid": e.rid, "ts": us(e.ts_ns),
                        "args": dict(e.data or {})})
        elif e.kind == "req.phase":
            # phase-ledger entries: the interval already elapsed when the
            # phase was reported, so an X slice would spill outside the
            # request span — render as an instant carrying the duration
            d = dict(e.data or {})
            d["dur_ms"] = (e.dur_ns or 0) / 1e6
            out.append({"name": f"phase:{d.get('phase', '?')}",
                        "cat": "serving", "ph": "i", "s": "t",
                        "pid": serving_pid, "tid": e.rid,
                        "ts": us(e.ts_ns), "args": d})
        elif e.kind == "decode.tick":
            d = dict(e.data or {})
            for rid in d.get("rids", ()):
                out.append({"name": "decode", "cat": "serving", "ph": "X",
                            "pid": serving_pid, "tid": rid,
                            "ts": us(e.ts_ns), "dur": (e.dur_ns or 0) / 1e3,
                            "args": {"n": d.get("n")}})
        elif e.kind == "sched.gauge":
            d = dict(e.data or {})
            out.append({"name": "queue_depth", "ph": "C", "pid": engine_pid,
                        "tid": _ENGINE_TID, "ts": us(e.ts_ns),
                        "args": {"queued": d.get("queued", 0),
                                 "running": d.get("running", 0)}})
            out.append({"name": "kv_blocks", "ph": "C", "pid": engine_pid,
                        "tid": _ENGINE_TID, "ts": us(e.ts_ns),
                        "args": {"used": d.get("kv_used", 0),
                                 "free": d.get("kv_free", 0)}})
        elif e.kind == "kv.spill":
            # demotions have no single request: they happen inside another
            # request's allocation, so they render on the engine track
            out.append({"name": "kv_spill", "cat": "serving", "ph": "X",
                        "pid": engine_pid, "tid": _ENGINE_TID,
                        "ts": us(e.ts_ns), "dur": (e.dur_ns or 0) / 1e3,
                        "args": dict(e.data or {})})
        elif e.kind == "serve.end":
            out.append({"name": "generate_batch", "cat": "serving",
                        "ph": "X", "pid": engine_pid, "tid": _ENGINE_TID,
                        "ts": us(e.ts_ns), "dur": (e.dur_ns or 0) / 1e3,
                        "args": dict(e.data or {})})
        elif e.kind == "serve.drain":
            out.append({"name": "drain", "cat": "serving", "ph": "i",
                        "s": "p", "pid": engine_pid, "tid": _ENGINE_TID,
                        "ts": us(e.ts_ns), "args": dict(e.data or {})})
        elif e.kind == "serve.route":
            # replica-router decisions render on the engine track: the
            # trace shows WHICH replica each request landed on and WHY
            # (affinity re-hit, least-loaded, drain failover, handoff)
            out.append({"name": "route", "cat": "serving", "ph": "i",
                        "s": "t", "pid": engine_pid, "tid": _ENGINE_TID,
                        "ts": us(e.ts_ns), "args": dict(e.data or {})})
        elif e.kind == "serve.handoff":
            # prefill->decode transfer completion (the router's causal
            # stitch point; the fleet renderer also draws flow arrows)
            out.append({"name": "handoff", "cat": "serving", "ph": "i",
                        "s": "t", "pid": engine_pid, "tid": _ENGINE_TID,
                        "ts": us(e.ts_ns), "args": dict(e.data or {})})
        elif e.kind in ("serve.fault", "serve.restart"):
            # containment/recovery belongs to the engine timeline: the
            # trace shows WHEN the step died / the engine rebuilt relative
            # to the request spans it re-queued
            out.append({"name": e.kind.split(".", 1)[1], "cat": "serving",
                        "ph": "i", "s": "p", "pid": engine_pid,
                        "tid": _ENGINE_TID, "ts": us(e.ts_ns),
                        "args": dict(e.data or {})})
        elif e.kind == "slo.breach":
            # burn-rate alerts belong to the engine timeline: the trace
            # shows WHEN the budget blew relative to the request spans
            out.append({"name": "slo_breach", "cat": "serving", "ph": "i",
                        "s": "p", "pid": engine_pid, "tid": _ENGINE_TID,
                        "ts": us(e.ts_ns), "args": dict(e.data or {})})
        elif e.kind in ("ctl.apply", "ctl.revert"):
            # controller knob applications on the engine timeline (the
            # serving thread mutates between steps, so the instant sits
            # exactly where the posture changed relative to the request
            # spans), plus a per-knob counter track plotting the value
            d = dict(e.data or {})
            out.append({"name": e.kind.replace(".", "_"), "cat": "serving",
                        "ph": "i", "s": "p", "pid": engine_pid,
                        "tid": _ENGINE_TID, "ts": us(e.ts_ns), "args": d})
            if d.get("knob") is not None and d.get("value") is not None:
                out.append({"name": f"ctl/knob:{d['knob']}", "ph": "C",
                            "pid": engine_pid, "tid": _ENGINE_TID,
                            "ts": us(e.ts_ns),
                            "args": {"value": d["value"]}})

    out.append({"ph": "M", "name": "process_name", "pid": serving_pid,
                "args": {"name": f"{name_prefix}serving requests"}})
    out.append({"ph": "M", "name": "process_name", "pid": engine_pid,
                "args": {"name": f"{name_prefix}serving engine"}})
    out.append({"ph": "M", "name": "thread_name", "pid": engine_pid,
                "tid": _ENGINE_TID, "args": {"name": "engine steps"}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_serving_trace(events: Iterable[Event], path: str) -> str:
    """Write :func:`render_serving_trace` of ``events`` to ``path``."""
    doc = render_serving_trace(events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# ------------------------------------------------------------------ #
# fleet trace rendering: every replica's slice of the (shared) ring as
# its own track group on ONE timeline, router decisions on their own
# track, and chrome-trace flow arrows stitching the prefill->decode
# handoff across replicas

_ROUTER_PID = 99      # the replica router's decision track
_ROUTER_TID = 0


def render_fleet_trace(events: Iterable[Event]) -> Dict[str, Any]:
    """Merge a replica fleet's serving events onto ONE chrome-trace
    timeline: each replica (the ``replica=`` tag :class:`TaggedRecorder`
    stamps) renders as its own process pair via
    :func:`render_serving_trace` with a SHARED epoch, router decisions
    (``serve.route`` / ``serve.handoff``) land on a dedicated router
    track, and every causal handoff — requests sharing a ``trace=`` id
    across different replicas — gets a ``ph:"s"``/``ph:"f"`` flow arrow
    from the prefill-side span's close to the decode-side span's
    admission, so Perfetto draws the cross-replica hop that a
    per-replica export cannot show."""
    events = [e for e in events
              if e.kind.startswith(("req.", "serve.", "decode.", "sched.",
                                    "kv.", "slo.", "ctl."))]
    out: List[Dict[str, Any]] = []
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t0 = min(e.ts_ns for e in events)

    def us(ts_ns: int) -> float:
        return (ts_ns - t0) / 1e3

    # ---- split the router plane from the per-replica groups ---- #
    router_events: List[Event] = []
    groups: Dict[str, List[Event]] = {}
    for e in events:
        if e.kind in ("serve.route", "serve.handoff"):
            router_events.append(e)
        else:
            groups.setdefault((e.data or {}).get("replica", "r0"),
                              []).append(e)

    pids: Dict[str, int] = {}              # replica -> its request pid
    for i, name in enumerate(sorted(groups)):
        spid, epid = 2 * i + 1, 2 * i + 2
        pids[name] = spid
        doc = render_serving_trace(groups[name], t0_ns=t0,
                                   serving_pid=spid, engine_pid=epid,
                                   name_prefix=f"{name} ")
        out.extend(doc["traceEvents"])

    for e in router_events:
        out.append({"name": "route" if e.kind == "serve.route"
                    else "handoff", "cat": "serving", "ph": "i", "s": "t",
                    "pid": _ROUTER_PID, "tid": _ROUTER_TID,
                    "ts": us(e.ts_ns), "args": dict(e.data or {})})
    if router_events:
        out.append({"ph": "M", "name": "process_name", "pid": _ROUTER_PID,
                    "args": {"name": "replica router"}})
        out.append({"ph": "M", "name": "thread_name", "pid": _ROUTER_PID,
                    "tid": _ROUTER_TID, "args": {"name": "decisions"}})

    # ---- flow arrows: requests chained by a shared trace id ---- #
    # rids are per-engine counters, so cross-replica collisions are the
    # NORM (both sides of a handoff are often rid 0): every lookup keys
    # on (replica, rid)
    enq: Dict[Any, Any] = {}        # (replica, rid) -> (enqueue ts, trace)
    admits: Dict[Any, int] = {}
    ends: Dict[Any, int] = {}
    for e in events:
        if e.rid is None:
            continue
        key = ((e.data or {}).get("replica", "r0"), e.rid)
        if e.kind == "req.enqueue":
            tr = (e.data or {}).get("trace")
            if tr is not None:
                enq[key] = (e.ts_ns, tr)
        elif e.kind == "req.admit":
            admits.setdefault(key, e.ts_ns)
        elif e.kind in _SPAN_CLOSERS:
            ends[key] = e.ts_ns
    by_trace: Dict[Any, List] = {}
    for (rep, rid), (ts, tr) in enq.items():
        by_trace.setdefault(tr, []).append((ts, rid, rep))
    for tr in sorted(by_trace, key=str):
        hops = sorted(by_trace[tr])        # causal order = enqueue order
        for k, ((ts_a, rid_a, rep_a), (ts_b, rid_b, rep_b)) \
                in enumerate(zip(hops, hops[1:])):
            if rep_a == rep_b or rep_a not in pids or rep_b not in pids:
                continue
            fid = f"{tr}/{k}"
            out.append({"name": "handoff", "cat": "handoff", "ph": "s",
                        "id": fid, "pid": pids[rep_a], "tid": rid_a,
                        "ts": us(ends.get((rep_a, rid_a), ts_a))})
            out.append({"name": "handoff", "cat": "handoff", "ph": "f",
                        "bp": "e", "id": fid, "pid": pids[rep_b],
                        "tid": rid_b,
                        "ts": us(admits.get((rep_b, rid_b), ts_b))})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_fleet_trace(sources, path: str) -> str:
    """Write :func:`render_fleet_trace` to ``path``. ``sources`` is an
    iterable of :class:`Event` (e.g. one shared ring's ``snapshot()``),
    a single recorder, or a list of recorders — recorder snapshots are
    merged by timestamp with identity dedupe, so in-process replicas
    whose :class:`TaggedRecorder` wrappers share the ONE global ring
    merge without duplication."""
    items = [sources] if hasattr(sources, "snapshot") else list(sources)
    if items and hasattr(items[0], "snapshot"):
        seen: set = set()
        merged: List[Event] = []
        for rec in items:
            for e in rec.snapshot():
                if id(e) not in seen:
                    seen.add(id(e))
                    merged.append(e)
        merged.sort(key=lambda e: e.ts_ns)
        events = merged
    else:
        events = items
    doc = render_fleet_trace(events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def dump_events_jsonl(dirpath: str,
                      filename: str = "events.jsonl") -> Optional[str]:
    """Post-mortem helper: write the global recorder's tail into
    ``dirpath/filename`` when recording is on and anything was captured.
    Never raises (debug artifacts must not break the failing path);
    returns the path or None."""
    try:
        rec = get_flight_recorder()
        if not rec.enabled or not len(rec):
            return None
        return rec.write_jsonl(os.path.join(dirpath, filename))
    except Exception:
        return None
