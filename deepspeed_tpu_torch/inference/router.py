"""Replica scale-out: the ``dp`` serving axis behind a deterministic
affinity router (the port of ``deepspeed_tpu/inference/router.py``).

N engine replicas share one weight tree (build the extra engines with
``params=engine.params``), each behind its own always-on
:class:`~deepspeed_tpu_torch.inference.serve.AsyncServingEngine` loop and
each a fault domain of its own. :class:`ReplicaRouter` fronts them with the
single-engine surface (``add_request`` handles, ``/healthz`` and
``/metrics`` through ``build_http_server``, ``drain`` / ``shutdown``), so
``serve --replicas N`` is a drop-in swap. On one card the replicas share
its memory and its default stream (``PERF.md`` says what that costs).

Routing is deterministic given a request trace: every decision is a
function of the session key, the router's own outstanding-request counts
and each replica's restart count (no wall clock, no randomness), so a
replayed trace gives an identical ``decisions`` list. The three rules, in
order:

- **session affinity**: a request with a ``session`` key hashes (blake2b)
  onto a stable replica, so multi-turn traffic re-hits the prefix cache
  its earlier turns built;
- **least-loaded tiebreak** for fresh sessions: the healthy replica with
  the smallest (queue depth, restarts, index);
- **failover**: an unhealthy preferred replica falls through to the
  least-loaded healthy one.

Role split (disaggregated prefill and decode): a ``prefill`` replica runs
a prompt's prefill, commits its blocks, then force-demotes them into the
shared content-addressed
:class:`~deepspeed_tpu_torch.inference.kv_host_pool.KvHostPool`; the
``decode`` replica's admission finds the chain there and fetches it
instead of recomputing (the host tier is the KV transport). A fetched
block is bit-equal to what recompute would write on the same replica's
kernels, so tokens do not change.

Fault drain: a replica whose crash-loop breaker opens fails its in-flight
requests; the router replays each on a healthy sibling from the prompt
(greedy decode re-derives the same tokens) and forwards only the suffix the
client has not seen. Every decision emits a ``serve.route`` event, a drain
emits ``serve.drain`` with the replica label, and the ``router/*`` series
feed the health summary's and ``top``'s replicas pane.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.inference.serve import (
    CANCELLED, ERROR, FINISHED, REJECTED, TIMEOUT, RequestFailed)

#: replica role tags ("serving.replicas.roles")
ROLES = ("any", "prefill", "decode")


class RouterHandle:
    """One routed request's streaming surface — mirrors
    :class:`~deepspeed_tpu_torch.inference.serve.RequestHandle` (``generated``
    / ``stream`` / ``result`` / ``cancel`` / terminal ``status``) so the
    HTTP front door and client code are replica-count-agnostic. The
    router may move the request between replicas underneath (prefill
    warm-up, breaker-drain failover); the handle's token stream stays
    contiguous — on a failover replay the already-forwarded prefix is
    skipped, never re-emitted."""

    def __init__(self, router: "ReplicaRouter", prompt: np.ndarray,
                 max_new: Optional[int], eos: Optional[int], priority: int,
                 ttft_budget: Optional[int], deadline_ms: Optional[float],
                 deadline_steps: Optional[int], session: Optional[str]):
        self._router = router
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.priority = priority
        self.ttft_budget = ttft_budget
        self.deadline_ms = deadline_ms
        self.deadline_steps = deadline_steps
        self.session = session
        self.rid: Optional[int] = None     # the CURRENT replica's rid
        self.replica: Optional[str] = None  # current serving replica name
        self.status = "pending"
        self.error: Optional[str] = None
        self.retry_after: Optional[float] = None
        self._tokens: List[int] = []
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._lock = threading.RLock()
        # handoff/failover state machine: "warm" (prefill replica runs
        # the prompt) -> "demote" (blocks shipping into the host tier)
        # -> "running" (decode replica streams) ; non-handoff requests
        # start at "running"
        self._stage = "running"
        self.trace: Optional[str] = None   # router-minted causal trace id
        #                                    (deterministic: decision seq)
        self._inner = None                 # current RequestHandle
        self._inner_idx: Optional[int] = None
        self._warm = None                  # prefill warm-up handle
        self._warm_idx: Optional[int] = None
        self._demote_evt: Optional[threading.Event] = None
        self._demote_t0: Optional[float] = None   # handoff phase clock
        self._target_idx: Optional[int] = None   # decode-side target
        self._skip = 0          # failover replay: tokens already forwarded
        self._failovers = 0
        self._cancelled = False

    # ---- router side ---- #

    def _push(self, burst: List[int]) -> None:
        self._tokens.extend(burst)
        if self.status in ("pending", "queued"):
            self.status = "running"
        self._q.put(("tokens", burst))

    def _finish(self, status: str, error: Optional[str] = None) -> None:
        if self._done.is_set():
            return
        self.status = status
        self.error = error
        self._done.set()
        self._q.put(("done", status, error))

    # ---- consumer side (any thread) ---- #

    @property
    def generated(self) -> List[int]:
        """Tokens streamed so far (a snapshot copy)."""
        return list(self._tokens)

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Cancel wherever the request currently lives (idempotent)."""
        with self._lock:
            self._cancelled = True
            if self._warm is not None and not self._warm.done():
                self._warm.cancel()
            if self._inner is not None:
                self._inner.cancel()
        self._router._advance(self)

    def stream(self, timeout: Optional[float] = None):
        """Iterate token bursts in emission order (the
        ``RequestHandle.stream`` contract: StopIteration on any terminal
        status except ``error`` -> :class:`RequestFailed`; ``timeout``
        is per burst -> ``queue.Empty``). Pumps the router between
        waits so prefill handoffs and failovers make progress even when
        nothing else drives it."""
        while True:
            waited = 0.0
            while True:
                self._router._advance(self)
                slice_s = 0.02 if timeout is None else \
                    min(0.02, max(timeout - waited, 0.001))
                try:
                    item = self._q.get(timeout=slice_s)
                    break
                except queue.Empty:
                    if timeout is not None:
                        waited += slice_s
                        if waited >= timeout:
                            raise
            if item[0] == "tokens":
                yield item[1]
                continue
            _, status, error = item
            if status == ERROR:
                raise RequestFailed(error or "request failed")
            return

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal; full sequence (prompt + generated) as
        1-D int32. Raises :class:`RequestFailed` on
        ``error``/``rejected``/``timeout`` status."""
        t0 = time.monotonic()
        while not self._done.is_set():
            self._router._advance(self)
            if self._done.wait(0.02):
                break
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"request {self.rid} still in flight "
                                   f"after {timeout}s")
        if self.status in (ERROR, REJECTED, TIMEOUT):
            raise RequestFailed(
                f"request {self.rid} {self.status}: {self.error}")
        if not self._tokens:
            return self.prompt.copy()
        return np.concatenate(
            [self.prompt, np.asarray(self._tokens, np.int32)])


class ReplicaRouter:
    """Deterministic affinity router over N
    :class:`~deepspeed_tpu_torch.inference.serve.AsyncServingEngine` replicas.

    ``replicas`` share one weight tree (build the extra engines with
    ``params=engine.params``) and — for the prefill/decode role split —
    one host KV tier (``engine.ensure_host_kv_pool()`` +
    ``adopt_host_kv_pool``). ``roles`` tags each replica ``"any"`` |
    ``"prefill"`` | ``"decode"``; ``prefill`` replicas never serve
    decode traffic, they warm prompts and ship the blocks host-side.
    ``affinity=False`` disables session hashing (every request takes the
    least-loaded path); ``handoff=False`` disables the disaggregated
    prefill path even when a prefill replica exists. Defaults resolve
    from the first engine's ``serving.replicas`` config section.

    The router presents the single-engine serving surface
    (``add_request`` / ``drain`` / ``shutdown`` / ``health_state`` /
    ``engine`` / ``policy``), so :func:`~deepspeed_tpu_torch.inference.serve.
    build_http_server` fronts it unchanged: ``/healthz`` aggregates (503
    only when NO replica can serve), ``/metrics`` carries per-replica
    ``router/*`` series. Synchronous replicas (``start=False``) are
    driven with :meth:`step`, giving trace-replay determinism; threaded
    replicas pump through the handles' wait loops.

    ``decisions`` records every routing choice — ``{"seq", "replica",
    "reason", "session"}`` with reason one of ``affinity`` |
    ``least_loaded`` | ``failover`` | ``handoff`` | ``prefill`` — and is
    replay-identical for a replayed trace (the unit suite pins this).
    """

    def __init__(self, replicas, *, names: Optional[List[str]] = None,
                 roles: Optional[List[str]] = None,
                 affinity: Optional[bool] = None,
                 handoff: Optional[bool] = None, registry=None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = list(replicas)
        n = len(self.replicas)
        self.names = list(names) if names is not None else \
            [f"r{i}" for i in range(n)]
        if len(self.names) != n or len(set(self.names)) != n:
            raise ValueError(f"need {n} unique replica names, "
                             f"got {self.names}")
        rep_cfg = getattr(self.replicas[0].engine.config.serving,
                          "replicas", None)
        if roles is None:
            roles = list(getattr(rep_cfg, "roles", None) or [])
        roles = list(roles) + ["any"] * (n - len(roles))
        if len(roles) != n or any(r not in ROLES for r in roles):
            raise ValueError(f"roles must be {n} of {ROLES}, got {roles}")
        self.roles = roles
        if affinity is None:
            affinity = str(getattr(rep_cfg, "affinity", "session")) != "off"
        self.affinity = bool(affinity)
        # decode-capable replicas, in index order — the stable hash ring
        # for session affinity (membership never changes with health, so
        # a recovered replica gets its sessions back)
        self._serving_idx = [i for i in range(n)
                             if self.roles[i] != "prefill"]
        self._prefill_idx = [i for i in range(n)
                             if self.roles[i] == "prefill"]
        if not self._serving_idx:
            raise ValueError("at least one replica must be decode-capable "
                             "(role 'any' or 'decode')")
        if handoff is None:
            handoff = str(getattr(rep_cfg, "handoff", "auto")) != "off"
        self._handoff = bool(handoff) and bool(self._prefill_idx)
        # tag each replica's recorder + phase-ledger telemetry so fleet
        # merges and serving/phase_ms{replica=} carry the router's names
        for i, name in enumerate(self.names):
            self.replicas[i].engine.set_replica(name)
        self.decisions: List[Dict[str, Any]] = []
        self._seq = 0
        self._lock = threading.RLock()
        self._outstanding = [0] * n
        self._handles: List[RouterHandle] = []
        self._tripped: set = set()
        self._events = self.replicas[0].engine._events
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self._m_requests = registry.counter(
            "router/requests",
            "requests routed to each replica (reason-agnostic; includes "
            "prefill warm-ups and failover replays)", ("replica",))
        self._m_drained = registry.counter(
            "router/drained_requests",
            "requests drained AWAY from a breaker-tripped/unhealthy "
            "replica and replayed on a sibling", ("replica",))
        self._m_handoffs = registry.counter(
            "router/handoffs",
            "disaggregated prefill->decode handoffs completed (blocks "
            "shipped through the host KV tier)")
        self._m_healthy = registry.gauge(
            "router/healthy", "1 when the replica can serve (not stopped/"
            "crashed/breaker-tripped/draining)", ("replica",))
        self._m_depth = registry.gauge(
            "router/queue_depth",
            "router-tracked outstanding requests per replica (the "
            "least-loaded tiebreak's queue-depth signal)", ("replica",))
        for i, name in enumerate(self.names):
            self._m_requests.labels(replica=name)
            self._m_drained.labels(replica=name)
            self._m_healthy.labels(replica=name).set(
                1.0 if self._replica_healthy(i) else 0.0)
            self._m_depth.labels(replica=name).set(0.0)

    # ------------------------------------------------------------------ #
    # single-engine surface compatibility

    @property
    def engine(self):
        """The first replica's engine (model identity, config access)."""
        return self.replicas[0].engine

    @property
    def policy(self):
        return self.replicas[0].policy

    @property
    def _stopped(self) -> bool:
        return all(r._stopped for r in self.replicas)

    @property
    def error(self):
        """A loop crash, surfaced only once NO replica can serve — the
        aggregate stays scrapeable (/metrics 200) while any sibling
        still works."""
        if any(self._replica_healthy(i) for i in range(len(self.replicas))):
            return None
        for r in self.replicas:
            if r.error is not None:
                return r.error
        return None

    @property
    def restarts(self) -> int:
        return sum(r.restarts for r in self.replicas)

    # ------------------------------------------------------------------ #
    # routing (deterministic)

    def _replica_healthy(self, i: int) -> bool:
        r = self.replicas[i]
        return not (r._stopped or r.error is not None or r._crash_loop
                    or r._draining)

    def _load_key(self, i: int):
        # queue depth (router-tracked outstanding — deterministic, unlike
        # a cross-thread sched peek), then burn (engine restarts: a
        # replica burning its error budget loses ties), then index
        return (self._outstanding[i], self.replicas[i].restarts, i)

    def _affine_idx(self, session: str) -> int:
        ring = self._serving_idx
        d = hashlib.blake2b(session.encode("utf-8"), digest_size=8).digest()
        return ring[int.from_bytes(d, "big") % len(ring)]

    def _pick_serving(self, exclude=()) -> Optional[int]:
        cands = [i for i in self._serving_idx
                 if i not in exclude and self._replica_healthy(i)]
        if not cands:
            # availability over specialization: with every decode-capable
            # replica down, a healthy prefill replica still serves
            cands = [i for i in range(len(self.replicas))
                     if i not in exclude and self._replica_healthy(i)]
        return min(cands, key=self._load_key) if cands else None

    def _pick_prefill(self) -> Optional[int]:
        cands = [i for i in self._prefill_idx if self._replica_healthy(i)]
        return min(cands, key=self._load_key) if cands else None

    def _record(self, reason: str, idx: int,
                session: Optional[str]) -> None:
        # caller holds self._lock
        d = {"seq": self._seq, "replica": self.names[idx],
             "reason": reason, "session": session or ""}
        self._seq += 1
        self.decisions.append(d)
        self._m_requests.labels(replica=self.names[idx]).inc()
        if self._events is not None:
            self._events.emit("serve.route", seq=d["seq"],
                              replica=d["replica"], reason=reason,
                              session=d["session"])

    # ------------------------------------------------------------------ #
    # front-end (any thread)

    def add_request(self, prompt, max_new_tokens: Optional[int] = None,
                    eos_token_id: Optional[int] = None, priority: int = 0,
                    ttft_budget: Optional[int] = None,
                    deadline_ms: Optional[float] = None,
                    deadline_steps: Optional[int] = None,
                    session: Optional[str] = None) -> RouterHandle:
        """Route and submit one request; returns its streaming handle.
        ``session`` is the affinity key (multi-turn clients pass a
        stable id so follow-up turns re-hit the replica that cached
        their prefix); everything else matches
        ``AsyncServingEngine.add_request``. Raises RuntimeError when no
        replica can accept work (-> HTTP 503)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        h = RouterHandle(self, prompt, max_new=max_new_tokens,
                         eos=eos_token_id, priority=int(priority),
                         ttft_budget=ttft_budget,
                         deadline_ms=deadline_ms,
                         deadline_steps=deadline_steps, session=session)
        with self._lock:
            if session is not None and self.affinity:
                pref = self._affine_idx(str(session))
                if self._replica_healthy(pref):
                    idx, reason = pref, "affinity"
                else:
                    idx, reason = self._pick_serving(), "failover"
            else:
                idx, reason = self._pick_serving(), "least_loaded"
            if idx is None:
                raise RuntimeError(
                    "no healthy replica: every serving loop is stopped, "
                    "draining, or parked in its crash-loop breaker")
            h._target_idx = idx
            # causal trace id, minted from the first decision's seq —
            # deterministic under replay, unique per routed request
            h.trace = f"t{self._seq}"
            pidx = None
            if (self._handoff and idx not in self._prefill_idx
                    and prompt.size >= int(self.replicas[0].engine
                                           .config.serving.block_size)):
                pidx = self._pick_prefill()
            if pidx is not None:
                # disaggregated path: decision for the decode target is
                # recorded NOW (routing is a function of submission-time
                # state, replay-identical), the prefill warm-up gets its
                # own decision line
                self._record("handoff", idx, session)
                self._record("prefill", pidx, session)
            else:
                self._record(reason, idx, session)
            self._handles.append(h)
        with h._lock:
            if pidx is not None:
                self._submit_warm(h, pidx)
            else:
                self._submit_inner(h)
        return h

    def _submit_warm(self, h: RouterHandle, pidx: int) -> None:
        try:
            h._warm = self.replicas[pidx].add_request(
                h.prompt, max_new_tokens=1, priority=h.priority,
                trace=h.trace)
        except (RuntimeError, ValueError):
            # prefill replica refused (raced into drain/breaker, or the
            # prompt is never-admittable there): fall back to the plain
            # path — handoff is an optimization, not a correctness gate
            self._submit_inner(h)
            return
        h._warm_idx = pidx
        h._stage = "warm"
        with self._lock:
            self._outstanding[pidx] += 1

    def _submit_inner(self, h: RouterHandle,
                      exclude: tuple = ()) -> None:
        """Submit (or re-submit) the real request to its target replica,
        walking to the least-loaded healthy sibling when the target
        cannot take it. Terminal-fails the handle when nothing can."""
        idx = h._target_idx
        tried = set(exclude)
        while True:
            if idx is None or idx in tried or not self._replica_healthy(idx):
                with self._lock:
                    idx = self._pick_serving(exclude=tried)
                if idx is None:
                    h._finish(ERROR, h.error or
                              "no healthy replica to serve the request")
                    return
            try:
                inner = self.replicas[idx].add_request(
                    h.prompt, max_new_tokens=h.max_new,
                    eos_token_id=h.eos, priority=h.priority,
                    ttft_budget=h.ttft_budget, deadline_ms=h.deadline_ms,
                    deadline_steps=h.deadline_steps, trace=h.trace,
                    parent=(h._warm.rid if h._warm is not None
                            else None))
            except RuntimeError:
                # raced into drain/breaker between the health check and
                # the intake append — try the next healthy sibling
                tried.add(idx)
                idx = None
                continue
            h._inner = inner
            h._inner_idx = idx
            h.replica = self.names[idx]
            h._stage = "running"
            with self._lock:
                self._outstanding[idx] += 1
            return

    # ------------------------------------------------------------------ #
    # the pump: move each handle's state machine forward

    def _advance(self, h: RouterHandle) -> None:
        """Drain the handle's current inner queue(s) and run its
        handoff/failover transitions. Called from :meth:`step` (sync
        replay) and from the handle's own wait loops (threaded mode);
        idempotent and cheap when there is nothing to do."""
        if h._done.is_set():
            return
        with h._lock:
            if h._done.is_set():
                return
            if h._stage == "warm":
                self._pump_warm(h)
            if h._stage == "demote":
                if h._demote_evt is not None and h._demote_evt.is_set():
                    with self._lock:
                        self._m_handoffs.inc()
                    self._note_handoff(h)
                    self._submit_inner(h)
            if h._stage == "running" and h._inner is not None:
                self._pump_running(h)
        self._refresh_gauges()

    def _pump_warm(self, h: RouterHandle) -> None:
        w = h._warm
        if w is None or not w.done():
            return
        with self._lock:
            self._outstanding[h._warm_idx] -= 1
        if h._cancelled:
            h._finish(CANCELLED)
            return
        if w.status == FINISHED:
            # prompt blocks are committed cold on the prefill replica:
            # push them into the shared host tier, then hold the decode
            # submission until the demotion ran (the event) so the decode
            # admission probe finds the chain host-resident
            h._demote_evt = self.replicas[h._warm_idx].request_demote(
                h.prompt)
            h._demote_t0 = time.perf_counter()
            h._stage = "demote"
        else:
            # warm-up failed (rejected under pressure, faulted, timed
            # out): serve the plain way — the decode replica recomputes
            self._submit_inner(h)

    def _note_handoff(self, h: RouterHandle) -> None:
        """Handoff completed: the warmed blocks are host-resident and the
        decode-side submission goes out next. Emits the cross-replica
        ``serve.handoff`` flow anchor (rid = the prefill-side rid, so the
        fleet merge can pin the hop) and books the demote wall time as
        the ``handoff`` phase on the prefill replica's ledger."""
        wrid = h._warm.rid if h._warm is not None else None
        if self._events is not None:
            self._events.emit(
                "serve.handoff", rid=wrid, trace=h.trace,
                from_replica=self.names[h._warm_idx],
                to_replica=(self.names[h._target_idx]
                            if h._target_idx is not None else ""),
                replica=self.names[h._warm_idx])
        tel = self.replicas[h._warm_idx].engine._serving_tel
        if tel is not None and h._demote_t0 is not None:
            tel.phase("handoff",
                      max(time.perf_counter() - h._demote_t0, 0.0) * 1e3,
                      rid=wrid)

    def _pump_running(self, h: RouterHandle) -> None:
        inner = h._inner
        if h.rid is None and inner.rid is not None:
            h.rid = inner.rid
        while True:
            try:
                item = inner._q.get_nowait()
            except queue.Empty:
                return
            if item[0] == "tokens":
                burst = item[1]
                if h._skip:
                    # failover replay: the sibling re-derives the full
                    # greedy stream; drop the prefix the client already
                    # has and splice the continuation in seamlessly
                    take = burst[h._skip:]
                    h._skip = max(h._skip - len(burst), 0)
                    burst = take
                if burst:
                    h._push(burst)
                continue
            _, status, err = item
            with self._lock:
                self._outstanding[h._inner_idx] -= 1
            if (status in (ERROR, REJECTED)
                    and not self._replica_healthy(h._inner_idx)
                    and not h._cancelled):
                # the replica died under the request (breaker trip, loop
                # crash) — that is the replica's fault, not the
                # request's: drain it to a sibling
                self._failover(h, err)
                if h._inner is inner:
                    return           # no sibling: handle already failed
                inner = h._inner     # pump the replay immediately
                continue
            h.retry_after = inner.retry_after
            h._finish(status, err)
            return

    def _failover(self, h: RouterHandle, err: Optional[str]) -> None:
        from_idx = h._inner_idx
        name = self.names[from_idx]
        with self._lock:
            self._m_drained.labels(replica=name).inc()
            if from_idx not in self._tripped:
                self._tripped.add(from_idx)
                if self._events is not None:
                    sched = self.replicas[from_idx]._session.sched
                    self._events.emit(
                        "serve.drain", replica=name,
                        waiting=len(sched.waiting),
                        running=len(sched.running), pending=0)
            idx = self._pick_serving(exclude={from_idx})
            if idx is not None:
                h._target_idx = idx
                self._record("failover", idx, h.session)
        if idx is None:
            h._finish(ERROR, err or f"replica {name} failed and no "
                                    "healthy sibling remains")
            return
        # wasted-work ledger: every token the failed replica produced is
        # recomputed by the sibling's replay (booked on the FAILED
        # replica — the waste is its fault domain's)
        tel = self.replicas[from_idx].engine._serving_tel
        if tel is not None and h._tokens:
            tel.waste("failover", len(h._tokens))
        h._skip = len(h._tokens)
        h._failovers += 1
        h.rid = None
        self._submit_inner(h, exclude=(from_idx,))

    def _refresh_gauges(self) -> None:
        with self._lock:
            for i, name in enumerate(self.names):
                self._m_healthy.labels(replica=name).set(
                    1.0 if self._replica_healthy(i) else 0.0)
                self._m_depth.labels(replica=name).set(
                    float(self._outstanding[i]))

    # ------------------------------------------------------------------ #
    # lifecycle

    def step(self) -> bool:
        """Synchronous replay step (every replica built with
        ``start=False``): one ``step()`` per live replica, then one pump
        per live handle. Returns False once every replica is idle and
        every handle is terminal — ``while router.step(): pass`` runs a
        trace to completion deterministically."""
        busy = False
        for r in self.replicas:
            if r._thread is None and not r._stopped:
                if r.step():
                    busy = True
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            self._advance(h)
            if h._done.is_set():
                with self._lock:
                    if h in self._handles:
                        self._handles.remove(h)
            else:
                busy = True
        self._refresh_gauges()
        return busy

    def export_fleet_trace(self, path: str) -> str:
        """Merge every replica's serving events plus the router's own
        decision/handoff markers onto ONE Perfetto timeline (chrome
        trace JSON) with flow arrows across prefill→decode handoffs.
        Replicas share the process-global flight-recorder ring, so the
        first replica's snapshot already covers the fleet."""
        from deepspeed_tpu_torch.monitor.events import export_fleet_trace
        if self._events is None:
            raise RuntimeError("flight recorder disabled "
                               "(telemetry.events.enable)")
        return export_fleet_trace(self._events.snapshot(), path)

    def health_state(self):
        """Aggregate ``(status_code, body)`` for ``/healthz``: 503 only
        when NO replica can serve; the body carries the single-engine
        keys (summed) plus a per-replica breakdown."""
        reps: Dict[str, Any] = {}
        n_ok = 0
        depth = running = restarts = 0
        ticks = 0
        for i, r in enumerate(self.replicas):
            code, body = r.health_state()
            body["role"] = self.roles[i]
            reps[self.names[i]] = body
            if code == 200:
                n_ok += 1
            depth += body["queue_depth"]
            running += body["running"]
            restarts += body["restarts"]
            ticks = max(ticks, body["uptime_ticks"])
        state = ("serving" if n_ok else
                 "stopped" if self._stopped else "crash_loop")
        return (200 if n_ok else 503), {
            "state": state, "stopped": self._stopped,
            "queue_depth": depth, "running": running,
            "restarts": restarts, "uptime_ticks": ticks,
            "healthy_replicas": n_ok,
            "total_replicas": len(self.replicas), "replicas": reps}

    def drain(self) -> None:
        for r in self.replicas:
            r.drain()

    def join(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for r in self.replicas:
            left = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            ok = r.join(left) and ok
        return ok

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop every replica. In synchronous mode a draining shutdown
        first pumps the router to completion (handoffs still need NEW
        submissions, which a draining replica would reject), then drains
        each loop; re-raises the first replica crash encountered."""
        if drain and all(r._thread is None for r in self.replicas):
            while self.step():
                pass
        first: Optional[BaseException] = None
        for r in self.replicas:
            try:
                r.shutdown(drain=drain, timeout=timeout)
            except Exception as e:  # noqa: BLE001 — stop the REST first
                if first is None:
                    first = e
        with self._lock:
            handles = list(self._handles)
            self._handles.clear()
        for h in handles:
            self._advance(h)
            h._finish(CANCELLED, "serving loop shut down")
        self._refresh_gauges()      # the pane flips to DOWN immediately
        if first is not None:
            raise first

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
