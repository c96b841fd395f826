"""Always-on async serving front-end over the paged engine (the port of
``deepspeed_tpu/inference/serve.py``).

``generate_batch`` is a closed loop: the request set is fixed up front and
the call returns when the last one retires. This module opens it:
:class:`AsyncServingEngine` runs the same serving session
(``engine.open_serve_session``: the same scheduler, pools and kernels) on a
serving thread of its own and accepts :meth:`~AsyncServingEngine.add_request`
from any thread at any time. Each submission returns a
:class:`RequestHandle` that streams token bursts back as they are emitted
(speculation's verified multi-token steps arrive as multi-token bursts) and
ends with a status (``finished`` / ``cancelled`` / ``error`` /
``rejected`` / ``timeout``).

Fault tolerance (``serving.fault``): an exception in an engine step does
not kill the loop. A per-request fault re-queues the faulting requests
through recompute-preemption with logical-step backoff (quarantine after
``max_request_retries``); an engine-fatal fault (the pools half-written by
a forward that did not finish) rebuilds the pools and re-admits every
in-flight request, at most ``max_engine_restarts`` times before the
crash-loop breaker parks the loop (``/healthz`` 503; drain still works).
Requests may carry deadlines (wall-clock ``deadline_ms`` / logical
``deadline_steps``), and the loop sheds the lowest-priority queued work
above ``shed_queue_depth``. All of it is deterministic given a request
trace and an injection schedule (``utils/fault_injection.fail_step``).

Threading: the serving thread owns the engine. Submissions, cancellations
and knob movements are commands on a lock-guarded intake deque that the
loop drains between engine steps, so the scheduler and the pools are only
touched by one thread. The loop waits on a condition variable when nothing
is queued or running.

Determinism: the scheduler and its policies (``inference/policy.py``)
decide from trace state (arrival order, priorities, the logical step
clock), so the same interleaving of submissions, cancellations and steps
gives the same admissions, preemptions, retirements and greedy tokens.
Tests drive that interleaving synchronously (``start=False`` +
:meth:`AsyncServingEngine.step`); the serving thread runs the same step.

On top sits an OpenAI-style HTTP endpoint, ``POST /v1/completions`` with
``"stream": true`` server-sent events, ``GET /healthz`` and ``GET
/metrics``, run by ``python -m deepspeed_tpu_torch.cli serve``
(:func:`serve_main`). Prompts are token-id lists unless a tokenizer
callable is supplied.

The JAX loop enters ``engine._mesh_scope()`` around each step; the port
serves on one device and has no mesh to enter.
"""

from __future__ import annotations

import json
import math
import queue
import signal as _signal
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

#: terminal handle statuses
FINISHED, CANCELLED, ERROR, REJECTED, TIMEOUT = (
    "finished", "cancelled", "error", "rejected", "timeout")


class RequestFailed(RuntimeError):
    """The serving loop retired this request without completing it
    (rejected, quarantined after step-fault retries, deadline timeout,
    pool misconfiguration, loop crash)."""


class RequestHandle:
    """One submitted request's streaming surface. Produced by
    :meth:`AsyncServingEngine.add_request`; all methods are safe from any
    thread. ``status`` moves ``pending -> queued/running -> one of
    finished | cancelled | error | rejected | timeout``."""

    def __init__(self, owner: "AsyncServingEngine", prompt: np.ndarray,
                 max_new: int, eos: Optional[int], priority: int,
                 ttft_budget: Optional[int],
                 deadline_ms: Optional[float] = None,
                 deadline_steps: Optional[int] = None,
                 trace: Optional[str] = None,
                 parent: Optional[int] = None):
        self._owner = owner
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.priority = priority
        self.ttft_budget = ttft_budget
        self.deadline_ms = deadline_ms
        self.deadline_steps = deadline_steps
        self.trace = trace       # causal trace id (router-minted); carried
        self.parent = parent     # into req.enqueue for fleet trace merges
        self.rid: Optional[int] = None     # filled once the loop enqueues it
        self.status = "pending"
        self.error: Optional[str] = None
        self.retry_after: Optional[float] = None   # backpressure hint (s),
        # set on admission-control rejections (HTTP 429 Retry-After)
        self._tokens: List[int] = []
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._submit_perf = time.perf_counter()
        self._submit_ns = time.monotonic_ns()

    # ---- serving-thread side ---- #

    def _push(self, burst: List[int]) -> None:
        self._tokens.extend(burst)
        self._q.put(("tokens", burst))

    def _finish(self, status: str, error: Optional[str] = None) -> None:
        if self._done.is_set():
            return
        self.status = status
        self.error = error
        self._done.set()
        self._q.put(("done", status, error))

    # ---- consumer side ---- #

    @property
    def generated(self) -> List[int]:
        """Tokens streamed so far (a snapshot copy)."""
        return list(self._tokens)

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Ask the loop to cancel this request (idempotent; a request that
        already retired keeps its terminal status)."""
        self._owner._submit_cancel(self)

    def stream(self, timeout: Optional[float] = None):
        """Iterate token bursts in emission order: each item is a
        ``list[int]`` — one token per fused decode step, several per
        accepted speculative verify step. StopIteration on any terminal
        status except ``error``, which raises :class:`RequestFailed`;
        ``timeout`` (per burst) raises ``queue.Empty``."""
        while True:
            item = self._q.get(timeout=timeout)
            if item[0] == "tokens":
                yield item[1]
                continue
            _, status, error = item
            if status == ERROR:
                raise RequestFailed(error or "request failed")
            return

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal; the full sequence (prompt + generated —
        possibly partial for a cancelled request) as 1-D int32. Raises
        :class:`RequestFailed` on ``error``/``rejected``/``timeout``
        status."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight after "
                               f"{timeout}s")
        if self.status in (ERROR, REJECTED, TIMEOUT):
            raise RequestFailed(
                f"request {self.rid} {self.status}: {self.error}")
        if not self._tokens:
            return self.prompt.copy()
        return np.concatenate(
            [self.prompt, np.asarray(self._tokens, np.int32)])


class AsyncServingEngine:
    """The persistent serving loop: a thread-safe front-end over ONE
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine` serving
    session.

    ``policy`` overrides ``engine.config.serving.policy`` (a name, a
    ``{"name": ..., **kwargs}`` dict, or a
    :class:`~deepspeed_tpu_torch.inference.policy.SchedulingPolicy` instance).
    ``start=False`` skips the background thread — the embedder (tests,
    trace replay) drives :meth:`step` itself for a fully deterministic
    interleaving of arrivals and engine steps.

    Lifecycle: :meth:`drain` stops intake and serves out the backlog;
    :meth:`shutdown` drains (or aborts: ``drain=False`` cancels whatever
    is in flight), stops the thread, and hands the pool workspace back to
    the engine so a later ``generate_batch`` / loop re-hits the prefix
    cache. Also a context manager (``with`` = ``shutdown(drain=True)``).
    """

    def __init__(self, engine, *, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 eos_token_id: Optional[int] = None, policy=None,
                 start: bool = True):
        from deepspeed_tpu_torch.inference.policy import get_policy
        self.engine = engine
        if policy is None:
            policy = getattr(engine.config.serving, "policy", "fifo")
        self.policy = get_policy(policy)
        max_new = (max_new_tokens if max_new_tokens is not None
                   else engine.config.max_out_tokens)
        self._session = engine.open_serve_session(
            max_new=max_new, temperature=temperature, top_k=top_k,
            seed=seed, eos_token_id=eos_token_id, policy=self.policy,
            on_tokens=self._on_tokens, on_finish=self._on_finish,
            # results flow through on_finish; an always-on loop must
            # not accumulate every retired Request forever
            retain_finished=False)
        self._handles: Dict[int, RequestHandle] = {}     # rid -> handle
        self._cv = threading.Condition()
        self._intake: deque = deque()      # ("submit"|"cancel", handle)
        self._draining = False
        self._stop_now = False
        self._stopped = False
        self._finalized = False
        self._n_submitted = 0
        self.error: Optional[BaseException] = None
        # ---- adaptive controller (monitor/controller.py) ---- #
        # knob -> last applied action payload: the loop-local replica of
        # the decision ledger, re-applied after an engine restart so the
        # recovered engine comes back in the SAME posture it crashed in
        self._ctl_values: Dict[str, Dict] = {}
        self._shed_override = 0            # 0 = follow serving.fault config
        # ---- fault tolerance (serving.fault) ---- #
        self._fault_cfg = engine.config.serving.fault
        self.restarts = 0                  # engine-fatal recoveries so far
        self._unattributed_faults = 0      # consecutive no-op containments
        self._crash_loop = False           # breaker: restarts exhausted —
        # the loop parks, /healthz reads 503, drain()/shutdown() still work
        self._tpot_ema_s = 0.05            # recent per-token WALL rate (the
        # Retry-After backpressure hint's base): measured over emitted-
        # token windows, not per-row callback gaps — a fused step fires W
        # near-simultaneous callbacks, and a gap EMA would under-weight
        # the one real step-time sample W-fold
        self._rate_t0: Optional[float] = None   # window start (None = idle)
        self._rate_tokens = 0              # tokens emitted in the window
        self._t0 = time.monotonic_ns()
        ev = engine._events
        if ev is not None:
            ev.emit("serve.begin", t_ns=self._t0, requests=0)
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._run,
                                            name="ds-serve-loop", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ #
    # front-end (any thread)

    def add_request(self, prompt, max_new_tokens: Optional[int] = None,
                    eos_token_id: Optional[int] = None, priority: int = 0,
                    ttft_budget: Optional[int] = None,
                    deadline_ms: Optional[float] = None,
                    deadline_steps: Optional[int] = None,
                    session: Optional[str] = None,
                    trace: Optional[str] = None,
                    parent: Optional[int] = None) -> RequestHandle:
        """Submit one request; returns immediately with its streaming
        handle. Raises RuntimeError once the loop is draining/stopped or
        its crash-loop breaker is open. Admission control (the policy's
        queue/pool-pressure bounds) is applied on the serving thread — a
        refused submission terminates the handle with status
        ``"rejected"`` instead of raising here. ``deadline_ms`` (wall
        clock from submission) / ``deadline_steps`` (scheduler's logical
        clock) retire the request as ``"timeout"`` on expiry.
        ``session`` is the replica router's affinity key
        (``inference/router.py``) — accepted here for surface parity
        and ignored: one engine is trivially affine. ``trace`` /
        ``parent`` are the causal trace context (trace id + parent rid)
        stamped onto the request's ``req.enqueue`` event so
        ``export_fleet_trace`` can stitch cross-replica handoffs."""
        del session
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        h = RequestHandle(self, prompt,
                          max_new=(max_new_tokens if max_new_tokens
                                   is not None else self._session.max_new),
                          eos=(eos_token_id if eos_token_id is not None
                               else self._session.eos_token_id),
                          priority=int(priority), ttft_budget=ttft_budget,
                          deadline_ms=(None if deadline_ms is None
                                       else float(deadline_ms)),
                          deadline_steps=(None if deadline_steps is None
                                          else int(deadline_steps)),
                          trace=(None if trace is None else str(trace)),
                          parent=(None if parent is None else int(parent)))
        with self._cv:
            if self._crash_loop:
                raise RuntimeError(
                    "serving loop is parked in its crash-loop breaker "
                    "(engine restarts exhausted); /healthz reads 503")
            if self._draining or self._stop_now or self._stopped:
                raise RuntimeError(
                    "serving loop is draining/stopped; no new requests")
            self._intake.append(("submit", h))
            self._n_submitted += 1
            self._cv.notify_all()
        return h

    def _submit_cancel(self, h: RequestHandle) -> None:
        with self._cv:
            if self._stopped:
                return               # finalize already terminated every handle
            self._intake.append(("cancel", h))
            self._cv.notify_all()

    def apply_knobs(self, actions) -> None:
        """Queue adaptive-controller knob movements for application on
        the serving thread (the :class:`~deepspeed_tpu_torch.monitor.
        controller.AdaptiveController`'s ``apply_fn``). Mutation happens
        in :meth:`_step_once` between engine steps, so the session and
        the pools stay single-threaded, and each applied
        movement lands in the ledger as ``ctl.apply`` (``ctl.revert``
        when a relax returns the knob to its config baseline). Accepts
        :class:`KnobAction` objects or their payload dicts; silently
        dropped on a stopped or crash-looping loop (the posture of a
        dead engine is moot)."""
        payloads = [a.to_payload() if hasattr(a, "to_payload") else dict(a)
                    for a in actions]
        if not payloads:
            return
        with self._cv:
            if self._stopped or self._crash_loop:
                return
            self._intake.append(("knobs", payloads))
            self._cv.notify_all()

    def health_state(self):
        """``(status_code, body)`` for ``GET /healthz`` (JAX ``serve.py:350``).
        Load balancers key on the status code: a stopped, crashed or
        crash-looping loop reads 503; the body is the status-page
        detail."""
        dead = self._stopped or self.error is not None
        sched = self._session.sched
        state = ("stopped" if dead else
                 "crash_loop" if self._crash_loop else
                 "draining" if self._draining else "serving")
        body = {"state": state,
                "stopped": self._stopped,
                "queue_depth": len(sched.waiting),
                "running": len(sched.running),
                "restarts": self.restarts,
                "uptime_ticks": sched.step_seq}
        if self._ctl_values:
            # adaptive posture: knob -> applied value (why is in the
            # decision ledger / ctl/last_action gauges)
            body["ctl_knobs"] = {k: a.get("value")
                                 for k, a in sorted(self._ctl_values.items())}
        return (503 if (dead or self._crash_loop) else 200), body

    def drain(self) -> None:
        """Stop intake; the loop keeps stepping until everything in
        flight has retired. Non-blocking — pair with :meth:`join` or
        :meth:`shutdown`."""
        ev = self.engine._events
        with self._cv:
            if not self._draining:
                self._draining = True
                if ev is not None:
                    sched = self._session.sched
                    ev.emit("serve.drain", waiting=len(sched.waiting),
                            running=len(sched.running),
                            pending=len(self._intake))
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the loop thread to exit (after :meth:`drain` /
        :meth:`shutdown`). True when it did."""
        if self._thread is None:
            return self._stopped
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the loop. ``drain=True`` serves out the backlog first;
        ``drain=False`` cancels everything still in flight. Re-raises a
        loop crash (the handles it failed carry the same message)."""
        if drain:
            self.drain()
        else:
            with self._cv:
                self._stop_now = True
                self._draining = True
                self._cv.notify_all()
        if self._thread is not None:
            if not self.join(timeout):
                raise TimeoutError("serving loop did not stop in "
                                   f"{timeout}s")
        else:
            # synchronous mode: run the drain out (or abort) inline
            if drain:
                while self.step():
                    pass
            self._finalize()
        if self.error is not None:
            raise RequestFailed(
                f"serving loop crashed: {self.error!r}") from self.error

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)

    # ------------------------------------------------------------------ #
    # serving thread

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._intake and not self._stop_now
                           and not self._draining
                           and self._session.sched.all_done()):
                        self._cv.wait()      # idle: nothing queued/running
                if not self._step_once():
                    break
        except BaseException as e:  # noqa: BLE001 — loop must fail handles
            self.error = e
        finally:
            self._finalize()

    def step(self) -> bool:
        """Synchronous single step (``start=False`` mode): drain the
        intake, then run at most one engine step. Returns False when the
        loop would exit (drained) or idle (nothing runnable)."""
        if self._thread is not None:
            raise RuntimeError("step() is for start=False sessions; the "
                               "background thread owns this loop")
        if self._stopped:
            return False
        try:
            alive = self._step_once()
            if not alive:
                return False
            # "alive but idle" reads as False for a synchronous driver
            return (not self._session.sched.all_done()
                    or bool(self._intake))
        except BaseException as e:  # noqa: BLE001
            self.error = e
            self._finalize()
            raise

    def _step_once(self) -> bool:
        """One loop iteration: commands, load shedding, exit checks, one
        engine step with fault containment. Returns False when the loop
        should exit."""
        with self._cv:
            cmds = list(self._intake)
            self._intake.clear()
        for kind, h in cmds:
            if kind == "submit":
                self._process_submit(h)
            elif kind == "knobs":
                self._process_knobs(h)
            else:
                self._process_cancel(h)
        if self._stop_now:
            return False
        if self._crash_loop:
            # breaker open: nothing can run — park (the cv-wait predicate
            # holds, everything in flight was failed) until drain/shutdown
            return not self._draining
        self._shed_overload()
        if self._session.sched.all_done():
            # going idle: a rate window spanning the idle gap would read
            # as an enormous per-token latency and poison the hint's EMA
            self._rate_t0 = None
            return not self._draining
        from deepspeed_tpu_torch.inference.scheduler import PoolExhausted
        try:
            self._session.step()
            # a healthy step makes "consecutive" mean consecutive: rare
            # transient unattributed blips separated by normal traffic
            # must never accumulate their way into a restart/breaker
            self._unattributed_faults = 0
        except PoolExhausted as e:
            # one request outgrew the pool with nothing left to evict: the
            # closed loop fails the whole call, but an always-on server
            # must not die for everyone — retire the culprit with an error
            # (its handle reads status "error") and keep serving
            self._session.sched.fail_request(e.req, str(e))
            self._session._flush_finished()
        except Exception as e:  # noqa: BLE001 — the containment boundary:
            # SimulatedCrash (BaseException) and everything non-Exception
            # still kill the loop, exactly like the checkpoint writer
            self._contain(e)
        return True

    def _retry_after_hint(self) -> float:
        """Backpressure hint for 429 rejections (admission control, load
        shedding): roughly when a queue slot should open — queue depth x
        recent per-token wall rate x tokens per request, clamped to
        [1s, 120s]. The EMA measures the gap between consecutive bursts
        across ALL rows of the fused batch (W callbacks fire per decode
        step), so it already amortizes batch width — dividing by W again
        would understate the wait by ~W and defeat the backpressure."""
        depth = max(len(self._session.sched.waiting), 1)
        per_req_s = self._tpot_ema_s * self._session.max_new
        return min(max(depth * per_req_s, 1.0), 120.0)

    def _process_knobs(self, payloads) -> None:
        """Apply queued controller actions on the serving thread (the
        only thread allowed to touch the session, scheduler, allocator
        and policy) and ledger each one as ``ctl.apply``/``ctl.revert``."""
        ev = self.engine._events
        for a in payloads:
            name, value = a.get("knob"), a.get("value")
            if name is None or value is None:
                continue
            if not self._apply_one_knob(str(name), int(value)):
                continue                   # unknown knob: ledger nothing
            self._ctl_values[str(name)] = dict(a)
            if ev is not None:
                kind = ("ctl.revert" if a.get("direction") == "relax"
                        and a.get("at_baseline") else "ctl.apply")
                ev.emit(kind, knob=name, value=int(value),
                        prev=a.get("prev"), tick=a.get("tick"),
                        reason=a.get("reason"))

    def _apply_one_knob(self, name: str, value: int) -> bool:
        """One knob mutation (JAX ``serve.py:550``). Every target is plain
        host state read by the next step's scheduling and dispatch
        decisions."""
        sess = self._session
        sched = sess.sched
        if name == "prefill_chunk":
            # both homes: the scheduler decides WHETHER to chunk, the
            # session sizes each chunk step
            sess.chunk_tokens = value
            sched.chunk_tokens = value
            return True
        if name == "spec_k":
            if sched.spec_proposer is None:
                return False
            # the verify program pads to the FIXED window set at session
            # open, so any k <= the configured k is compile-free
            sched.spec_k = value
            return True
        if name == "max_queue":
            self.policy.admission_max_queue = value
            return True
        if name == "min_free_blocks":
            self.policy.admission_min_free_blocks = value
            return True
        if name == "shed_depth":
            self._shed_override = value
            return True
        # kv_spill moves the tiered KV cache's spill hook, which the port
        # does not have yet (ROADMAP.md queue 1): no effect, as in the JAX
        # loop on an engine without a host tier
        return False

    def _shed_overload(self) -> None:
        """Load shedding: with ``serving.fault.shed_queue_depth`` set,
        drop policy-selected queued requests (lowest priority first,
        deterministic) until the waiting queue fits the bound — graceful
        degradation instead of unbounded queue growth under pressure.
        A controller-tightened ``shed_depth`` overrides the config bound
        until the controller relaxes it back to baseline."""
        bound = (self._shed_override if self._shed_override > 0
                 else int(self._fault_cfg.shed_queue_depth))
        if bound <= 0:
            return
        sched = self._session.sched
        while len(sched.waiting) > bound:
            idx = self.policy.select_shed_victim(sched)
            if idx is None or not 0 <= idx < len(sched.waiting):
                break
            sched.shed_request(sched.waiting[idx])
        self._session._flush_finished()

    def _contain(self, exc: Exception) -> None:
        """Step-fault containment: per-request faults were already
        re-queued/quarantined by the session; an engine-fatal fault (the
        pools half-written by a forward that did not finish) triggers a
        restart —
        bounded by ``serving.fault.max_engine_restarts`` with exponential
        wall backoff — and, exhausted, opens the crash-loop breaker. An
        UNATTRIBUTED fault (no action to re-queue — e.g. a broken
        scheduling policy raising inside ``next_action``) is deterministic
        recurrence territory no per-request budget can bound: after
        ``max_request_retries`` consecutive occurrences it escalates to
        the restart path (and from there, the breaker) instead of letting
        the loop hot-spin on it forever."""
        try:
            outcome = self._session.contain_fault(exc)
        except Exception as inner:  # noqa: BLE001 — containment itself died
            self.error = inner
            raise
        if outcome == "request":
            self._unattributed_faults = 0
            return
        if outcome == "unattributed":
            self._unattributed_faults += 1
            if self._unattributed_faults \
                    <= int(self._fault_cfg.max_request_retries):
                return
            # fall through: escalate like an engine-fatal fault
        if self.restarts >= int(self._fault_cfg.max_engine_restarts):
            self._trip_breaker(exc)
            return
        backoff = float(self._fault_cfg.restart_backoff_s)
        if backoff > 0:
            time.sleep(min(backoff * (1 << self.restarts), 60.0))
        try:
            self._session.restart_engine()
        except Exception as rebuild_exc:  # noqa: BLE001 — a recovery that
            # cannot even rebuild its pools is a crash loop, not a retry
            self._trip_breaker(rebuild_exc)
            return
        # recorded only AFTER the rebuild succeeded: restarts/healthz and
        # the serve.restart event count PERFORMED recoveries, never an
        # attempt that itself crashed into the breaker
        self.restarts += 1
        self._unattributed_faults = 0
        ev = self.engine._events
        if ev is not None:
            ev.emit("serve.restart", restart=self.restarts,
                    error=f"{type(exc).__name__}: {exc}")
        tel = self._session.sched.telemetry
        if tel is not None:
            tel.engine_restarts.inc()
        # crash-safety for the adaptive posture: the rebuild re-derives
        # engine state from config, so every controller action applied
        # before the fault is re-applied FROM THE LEDGER replica — the
        # recovered engine serves in the posture it crashed in, and the
        # re-applications are themselves ledgered (restart=True)
        for name, a in sorted(self._ctl_values.items()):
            if not self._apply_one_knob(name, int(a["value"])):
                continue
            if ev is not None:
                ev.emit("ctl.apply", knob=name, value=int(a["value"]),
                        prev=a.get("prev"), tick=a.get("tick"),
                        reason=a.get("reason"), restart=True)

    def _trip_breaker(self, exc: Exception) -> None:
        self._crash_loop = True
        msg = (f"crash-loop breaker open after "
               f"{int(self._fault_cfg.max_engine_restarts)} engine "
               f"restart(s): {type(exc).__name__}: {exc}")
        sched = self._session.sched
        for r in list(sched.waiting) + list(sched.running):
            try:
                sched.fail_request(r, msg)
            except Exception:  # noqa: BLE001 — best-effort teardown: one
                # request's skewed bookkeeping must not strand the REST of
                # the handles un-terminated (their clients block forever)
                continue
        self._session._flush_finished()

    def _process_submit(self, h: RequestHandle) -> None:
        sched = self._session.sched
        if self._crash_loop:
            h._finish(REJECTED, "serving loop is parked in its crash-loop "
                                "breaker (engine restarts exhausted)")
            return
        if self._draining:
            # the drain/submit race's loser: the submission passed
            # add_request's flag check before drain() set it, but reached
            # the loop after — serving it would let a submission stream
            # extend "draining" forever, so it rejects instead (pinned)
            h._finish(REJECTED, "serving loop is draining; request "
                                "arrived after intake stopped")
            return
        if h.deadline_ms is not None and \
                (time.perf_counter() - h._submit_perf) * 1e3 > h.deadline_ms:
            # intake deadline check: already late before admission — retire
            # as timeout without burning a queue slot on it. Counter AND
            # event both fire (rid-less: the request never reached the
            # scheduler) so /metrics and the trace cannot disagree.
            if sched.telemetry is not None:
                sched.telemetry.timeouts.inc()
            ev = self.engine._events
            if ev is not None:
                ev.emit("req.timeout", generated=0,
                        error="deadline expired before admission")
            h._finish(TIMEOUT, f"deadline of {h.deadline_ms:.0f} ms expired "
                               "before the request reached the scheduler")
            return
        if not self.policy.admit_ok(sched, int(h.prompt.size)):
            if sched.telemetry is not None:
                sched.telemetry.rejected_requests.inc()
            h.retry_after = self._retry_after_hint()
            h._finish(REJECTED, "admission control refused the request "
                                "(queue bound / KV pool pressure)")
            return
        try:
            req = self._session.add(h.prompt, max_new=h.max_new, eos=h.eos,
                                    priority=h.priority,
                                    ttft_budget=h.ttft_budget,
                                    t_submit=h._submit_perf,
                                    deadline_ms=h.deadline_ms,
                                    deadline_steps=h.deadline_steps,
                                    trace=h.trace, parent=h.parent)
        except (ValueError, TypeError) as e:
            # oversized prompt / never-admittable: reject THIS handle, the
            # loop itself stays healthy
            h._finish(REJECTED, str(e))
            return
        h.rid = req.rid
        h.status = "queued"
        self._handles[req.rid] = h
        ev = self.engine._events
        if ev is not None:
            # after add_request (the rid is the scheduler's), stamped with
            # the caller-side submission time: ring order is emit order,
            # timestamps tell the true story (the validator does not
            # require monotone ts for exactly this reason)
            ev.emit("req.submit", rid=req.rid, t_ns=h._submit_ns,
                    prompt_tokens=int(h.prompt.size), priority=h.priority)

    def _process_cancel(self, h: RequestHandle) -> None:
        if h.done():
            return
        if h.rid is None:
            # submitted and cancelled inside one intake batch: the submit
            # was processed first (deque order), so rid is set unless the
            # submit was rejected — either way nothing is scheduled now
            h._finish(CANCELLED)
            return
        req = self._req_by_rid(h.rid)
        if req is not None:
            self._session.cancel(req)   # _on_finish terminates the handle
        else:
            h._finish(CANCELLED)

    def _req_by_rid(self, rid: int):
        sched = self._session.sched
        for r in list(sched.waiting) + sched.running:
            if r.rid == rid:
                return r
        return None

    # session callbacks (serving thread)

    def _on_tokens(self, req, tokens: List[int]) -> None:
        now = time.perf_counter()
        if self._rate_t0 is None:
            self._rate_t0, self._rate_tokens = now, 0
        self._rate_tokens += len(tokens)
        if self._rate_tokens >= 32 and now > self._rate_t0:
            # one wall-rate sample per ~32 emitted tokens: elapsed/tokens
            # is the batch-amortized per-token rate the Retry-After hint
            # needs, immune to the per-row callback clustering of a
            # fused step
            rate = (now - self._rate_t0) / self._rate_tokens
            self._tpot_ema_s += 0.3 * (min(rate, 10.0) - self._tpot_ema_s)
            self._rate_t0, self._rate_tokens = now, 0
        h = self._handles.get(req.rid)
        if h is not None:
            if h.status == "queued":
                h.status = "running"
            h._push(tokens)

    def _on_finish(self, req) -> None:
        h = self._handles.pop(req.rid, None)
        if h is None:
            return
        if req.cancelled:
            h._finish(CANCELLED)
        elif getattr(req, "timed_out", False):
            h._finish(TIMEOUT, req.error)
        elif getattr(req, "shed", False):
            h.retry_after = self._retry_after_hint()
            h._finish(REJECTED, req.error)
        elif req.error is not None:
            h._finish(ERROR, req.error)
        else:
            h._finish(FINISHED)

    def _finalize(self) -> None:
        """Terminal bookkeeping (idempotent): fail/cancel whatever is
        still in flight, close the session (rid uniqueness), and on a
        clean exit emit ``serve.end`` + hand the pools back."""
        if self._finalized:
            return
        self._finalized = True
        with self._cv:
            self._stopped = True
            leftovers = list(self._intake)
            self._intake.clear()
            self._cv.notify_all()
        msg = (f"serving loop terminated: {self.error!r}"
               if self.error is not None else None)
        for kind, h in leftovers:
            if kind == "submit":
                h._finish(REJECTED, msg or "serving loop stopped")
        if self.error is None and not self._session._closed:
            # aborting shutdown: retire everything still scheduled THROUGH
            # the scheduler so its KV blocks free and the persistent
            # allocator stays leak-free for the next session (on_finish
            # terminates each handle as "cancelled")
            sched = self._session.sched
            for r in list(sched.waiting) + list(sched.running):
                try:
                    self._session.cancel(r)
                except Exception:  # noqa: BLE001 — best-effort teardown
                    break
        for h in list(self._handles.values()):
            if self.error is not None:
                h._finish(ERROR, msg)
            else:
                h._finish(CANCELLED, "serving loop shut down")
        self._handles.clear()
        try:
            self._session.close()
            if self.error is None:
                ev = self.engine._events
                if ev is not None:
                    ev.emit("serve.end", t_ns=self._t0,
                            dur_ns=time.monotonic_ns() - self._t0,
                            requests=self._n_submitted)
                self._session.end()
        except Exception as e:  # noqa: BLE001 — shutdown must not raise
            if self.error is None:
                self.error = e


class ServeSignalHandler:
    """``dscli serve``'s graceful SIGTERM/SIGINT — the serving mirror of
    the checkpoint side's ``PreemptionHandler``: on the first signal, stop
    intake (new submissions 503) and unblock ``serve_forever`` so the main
    path can drain in-flight requests within a bounded grace period and
    exit ``128 + signum`` (supervisors see a conventional signal death).
    Re-entrant signals during the drain are ignored; previous handlers are
    restored on :meth:`uninstall` (the PR-6 handler-restore pattern).
    Install is a no-op off the main thread (signal handlers are
    main-thread-only — in-process test servers drive :meth:`trigger`
    directly)."""

    def __init__(self, server, serving: "AsyncServingEngine",
                 signals=(_signal.SIGTERM, _signal.SIGINT)):
        self.server = server
        self.serving = serving
        self.signals = tuple(signals)
        self.signum: Optional[int] = None
        self._prev: Dict[int, Any] = {}
        self._installed = False

    def install(self) -> "ServeSignalHandler":
        if self._installed or \
                threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.signals:
            self._prev[sig] = _signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def _handle(self, signum, frame) -> None:
        self.trigger(signum)

    def trigger(self, signum: int) -> None:
        """The handler body (callable directly by tests): first signal
        wins — stop intake, then shut the HTTP server down from another
        thread (``server.shutdown`` deadlocks the ``serve_forever``
        thread) so the caller's drain-and-exit path runs."""
        if self.signum is not None:
            return
        self.signum = int(signum)
        try:
            name = _signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        print(f"dscli serve: {name} received — stopping intake, draining "
              "in-flight requests", flush=True)
        try:
            self.serving.drain()       # new submissions now raise -> 503
        except Exception:  # noqa: BLE001 — the exit path must proceed
            pass
        threading.Thread(target=self.server.shutdown, daemon=True).start()


# ---------------------------------------------------------------------- #
# OpenAI-style HTTP front door (``dscli serve``)


def _sse(chunk: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(chunk).encode() + b"\n\n"


def build_http_server(serving: AsyncServingEngine, host: str = "127.0.0.1",
                      port: int = 8000,
                      tokenizer: Optional[Callable[[str], List[int]]] = None,
                      detokenizer: Optional[Callable[[List[int]], str]]
                      = None):
    """An ``http.server`` speaking the OpenAI completions shape over the
    async engine. ``POST /v1/completions`` accepts::

        {"prompt": [token ids] | "text" (needs a tokenizer),
         "max_tokens": 16, "stream": false, "priority": 0,
         "ttft_budget": null, "eos_token_id": null,
         "session": null}  # replica-router affinity key (multi-turn
                           # clients pass a stable id)

    Non-streaming responses return one ``text_completion`` object whose
    choice carries ``token_ids`` (and ``text`` when a detokenizer is
    wired). ``"stream": true`` responds ``text/event-stream``: one SSE
    ``data:`` chunk per emitted burst — speculation's multi-token bursts
    arrive as multi-id chunks — a final chunk with ``finish_reason``, then
    ``data: [DONE]``. ``GET /healthz`` reports loop liveness. Returns the
    (threaded) server; run ``serve_forever()`` on it — every connection
    handler thread only touches the thread-safe handle API."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def _ids(body):
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if tokenizer is None:
                raise ValueError("string prompts need a tokenizer; POST "
                                 "token ids: {\"prompt\": [464, 3290, ...]}")
            prompt = tokenizer(prompt)
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("prompt must be a non-empty list of token ids")
        return prompt

    def _text(ids: List[int]) -> str:
        return detokenizer(ids) if detokenizer is not None else ""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):   # quiet: dscli owns the console
            pass

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                code, body = serving.health_state()
                self._json(code, body)
            elif self.path == "/metrics":
                # Prometheus exposition of the process registry — the
                # scrape-and-alert plane's front door (one shared
                # rendering path with the standalone exporter; exemplars
                # only under negotiated OpenMetrics). Same liveness rule
                # as /healthz: a stopped loop's stale numbers must not
                # scrape as healthy 200s.
                dead = serving._stopped or serving.error is not None
                if dead:
                    self._json(503, {"error": "serving loop stopped"})
                    return
                from deepspeed_tpu_torch.monitor.exporter import (
                    render_exposition, wants_openmetrics)
                text, ctype = render_exposition(
                    openmetrics=wants_openmetrics(
                        self.headers.get("Accept")))
                payload = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                ids = _ids(body)
                # every body field coerced INSIDE the 400 path: a garbage
                # max_tokens/priority/ttft_budget is the client's error,
                # never a handler traceback (or, worse, a value smuggled
                # into the scheduling policy's math on the loop thread)
                max_tokens = int(body.get("max_tokens", 16))
                if max_tokens < 1:
                    raise ValueError("max_tokens must be >= 1")
                priority = int(body.get("priority", 0))
                ttft_budget = body.get("ttft_budget")
                if ttft_budget is not None:
                    ttft_budget = int(ttft_budget)
                deadline_ms = body.get("deadline_ms")
                if deadline_ms is not None:
                    deadline_ms = float(deadline_ms)
                    if deadline_ms <= 0:
                        raise ValueError("deadline_ms must be > 0")
                eos = body.get("eos_token_id")
                if eos is not None:
                    eos = int(eos)
                sess = body.get("session")
                if sess is not None:
                    sess = str(sess)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                h = serving.add_request(
                    ids, max_new_tokens=max_tokens, priority=priority,
                    ttft_budget=ttft_budget, deadline_ms=deadline_ms,
                    eos_token_id=eos, session=sess)
            except RuntimeError as e:   # draining/stopped/crash-loop
                self._json(503, {"error": str(e)})
                return
            rid_name = f"cmpl-{id(h):x}"
            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                try:
                    try:
                        for burst in h.stream():
                            self.wfile.write(_sse({
                                "id": rid_name,
                                "object": "text_completion",
                                "choices": [{"index": 0,
                                             "text": _text(burst),
                                             "token_ids": burst,
                                             "finish_reason": None}]}))
                            self.wfile.flush()
                        finish = {"finished": "stop"}.get(h.status, h.status)
                    except RequestFailed as e:
                        self.wfile.write(_sse({
                            "id": rid_name, "object": "text_completion",
                            "error": str(e)}))
                        finish = "error"
                    self.wfile.write(_sse({
                        "id": rid_name, "object": "text_completion",
                        "choices": [{"index": 0, "text": "",
                                     "token_ids": [],
                                     "finish_reason": finish}]}))
                    self.wfile.write(b"data: [DONE]\n\n")
                except OSError:
                    # client went away mid-stream: cancel the request so
                    # it stops burning decode steps and KV blocks — an
                    # abandoned stream must not decode to max_new
                    h.cancel()
                return
            try:
                h.result()
            except RequestFailed as e:
                if h.status == TIMEOUT:
                    # deadline expiry is a gateway-timeout, not our fault
                    self._json(504, {"error": str(e)})
                elif h.status == REJECTED and h.retry_after is not None:
                    # admission control / load shedding: backpressure the
                    # client with a Retry-After derived from queue depth x
                    # recent TPOT (the 429 contract retry loops key on)
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(429)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Retry-After",
                                     str(int(math.ceil(h.retry_after))))
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self._json(409 if h.status == REJECTED else 500,
                               {"error": str(e)})
                return
            gen = h.generated
            self._json(200, {
                "id": rid_name, "object": "text_completion",
                "model": type(serving.engine.module).__name__,
                "choices": [{"index": 0, "text": _text(gen),
                             "token_ids": gen,
                             "finish_reason": "stop"
                             if h.status == FINISHED else h.status}],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(gen),
                          "total_tokens": len(ids) + len(gen)}})

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    return Server((host, port), Handler)


def serve_main(argv=None, model=None, params=None,
               ready_cb: Optional[Callable] = None) -> int:
    """``serve``: stand the always-on loop up behind the HTTP endpoint
    (JAX ``serve.py:1152``). ``model``/``params``/``ready_cb`` are
    injection points for in-process tests (``ready_cb(server, serving)``
    fires once the socket is bound). The engine runs on ``cuda:0`` unless
    ``--device cpu`` is given."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli serve",
        description="OpenAI-style completions endpoint over the paged "
                    "continuous-batching engine (token-id prompts)")
    parser.add_argument("--model", default="gpt2:125m",
                        help="model zoo preset, e.g. gpt2:125m, llama:7b, llama:tiny")
    parser.add_argument("--checkpoint", default=None,
                        help="HF checkpoint dir/file to load weights from "
                             "(default: seeded random weights)")
    parser.add_argument("--dtype", default="bf16")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' serves on the "
                             "kernels' plain versions)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="TCP port (0 = ephemeral, printed once bound)")
    parser.add_argument("--max-new", type=int, default=128,
                        help="default max_tokens when a request omits it")
    parser.add_argument("--policy", default=None,
                        help="scheduling policy: fifo | priority | sla "
                             "(default: config serving.policy)")
    parser.add_argument("--block-size", type=int, default=128)
    parser.add_argument("--max-running", type=int, default=8)
    parser.add_argument("--max-blocks", type=int, default=0)
    parser.add_argument("--replicas", type=int, default=1,
                        help="engine replicas behind the affinity router "
                             "(not ported: more than 1 raises)")
    parser.add_argument("--replica-roles", default="",
                        help="per-replica roles (not ported: raises)")
    parser.add_argument("--spec", default="off",
                        help="speculative decoding: off | ngram")
    parser.add_argument("--telemetry", action="store_true",
                        help="enable telemetry + flight recorder")
    parser.add_argument("--sample-jsonl", default=None, metavar="PATH",
                        help="start the background metrics sampler, appending "
                             "registry snapshots to this rotated JSONL; "
                             "implies --telemetry")
    parser.add_argument("--sample-interval", type=float, default=1.0,
                        help="sampler cadence in seconds (default 1)")
    parser.add_argument("--slo-ttft-ms", type=float, default=0.0,
                        help="p99 TTFT objective in ms (0 = off): burn-rate "
                             "breaches fire slo.breach events; implies the sampler")
    parser.add_argument("--slo-tpot-ms", type=float, default=0.0,
                        help="p99 TPOT objective in ms (0 = off)")
    parser.add_argument("--adaptive", action="store_true",
                        help="the SLO-burn-rate autopilot (monitor/controller.py) "
                             "moves serving knobs under burn and steps them back "
                             "under headroom, every decision ledgered as ctl.* "
                             "events; implies the sampler")
    parser.add_argument("--grace", type=float, default=30.0,
                        help="SIGTERM/SIGINT drain grace period in seconds: "
                             "intake stops at once (503), in-flight requests get "
                             "this long to finish, then the exit code is 128+signum")
    args = parser.parse_args(argv)

    if int(args.replicas) > 1 or args.replica_roles:
        from deepspeed_tpu_torch.utils.not_ported import not_ported
        not_ported("serving replicas behind the router (--replicas, --replica-roles)",
                   "queue 1: sharded serving")
    import deepspeed_tpu_torch

    if model is None:
        from deepspeed_tpu_torch.models.presets import get_model
        name, _, size = args.model.partition(":")
        model = get_model(name, *([size] if size else []))
    serving_cfg = {"block_size": args.block_size,
                   "max_running": args.max_running,
                   "max_num_blocks": args.max_blocks,
                   "speculative": {"mode": args.spec}}
    if args.policy is not None:
        serving_cfg["policy"] = args.policy
    slo_on = bool(args.slo_ttft_ms or args.slo_tpot_ms)
    want_plane = bool(args.sample_jsonl or slo_on or args.adaptive)
    kwargs: Dict[str, Any] = {"dtype": args.dtype, "serving": serving_cfg}
    if args.telemetry or want_plane:
        kwargs["telemetry"] = {"events": True}
    if args.checkpoint:
        kwargs["checkpoint"] = args.checkpoint
    engine = deepspeed_tpu_torch.init_inference(model, params=params, device=args.device,
                                                **kwargs)
    serving = AsyncServingEngine(engine, max_new_tokens=args.max_new)
    sampler = None
    if want_plane:
        # the SLO engine evaluates on the sampler's ticks, and the adaptive
        # controller's apply_fn is the loop's knob intake
        from deepspeed_tpu_torch.monitor.sampler import MetricsSampler
        from deepspeed_tpu_torch.monitor.slo import (SloEngine, parse_objectives,
                                                     serving_objectives)
        slo = None
        if slo_on:
            slo = SloEngine(
                parse_objectives(serving_objectives(
                    ttft_p99_ms=args.slo_ttft_ms or None,
                    tpot_p99_ms=args.slo_tpot_ms or None)),
                events=engine._events)
        ctl = None
        if args.adaptive:
            from deepspeed_tpu_torch.monitor.controller import (AdaptiveController,
                                                                knobs_from_serving)
            knobs = knobs_from_serving(engine.config.serving, policy=serving.policy)
            if knobs:
                ctl = AdaptiveController(knobs, events=engine._events,
                                         apply_fn=serving.apply_knobs)
            else:
                print("dscli serve: --adaptive found no movable knobs "
                      "(chunking/spec/admission/shed all off); running "
                      "static", flush=True)
        sampler = MetricsSampler(interval_s=args.sample_interval,
                                 path=args.sample_jsonl, slo=slo,
                                 ctl=ctl).start()
    server = build_http_server(serving, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"dscli serve: {args.model} listening on "
          f"http://{host}:{port}/v1/completions "
          f"(policy={serving.policy.name}, device={engine.device}, "
          f"max_running={args.max_running}; metrics at /metrics)",
          flush=True)
    if ready_cb is not None:
        ready_cb(server, serving)
    # graceful preemption: SIGTERM/SIGINT stop intake and unblock
    # serve_forever; the finally below drains within --grace seconds and
    # the exit code is 128+signum (installation is a no-op off the main
    # thread: in-process tests reach the handler through the attribute
    # and call trigger() directly)
    handler = ServeSignalHandler(server, serving).install()
    serving._signal_handler = handler
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        handler.signum = handler.signum or _signal.SIGINT
    finally:
        server.server_close()
        try:
            try:
                serving.shutdown(drain=True, timeout=args.grace)
            except TimeoutError:
                # grace exhausted: cancel what is left rather than overstay
                # the supervisor's kill window
                print(f"dscli serve: drain grace of {args.grace:.0f}s "
                      "exhausted; cancelling in-flight requests",
                      flush=True)
                serving.shutdown(drain=False, timeout=10)
        except Exception as e:  # noqa: BLE001 — exit path
            print(f"dscli serve: shutdown error: {e}")
            return 1
        finally:
            handler.uninstall()
            if sampler is not None:
                sampler.stop()
    if handler.signum is not None:
        return 128 + int(handler.signum)
    return 0
