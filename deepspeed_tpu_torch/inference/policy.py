"""Pluggable scheduling policies for the continuous-batching scheduler (a
copy of ``deepspeed_tpu/inference/policy.py``, kept identical).

The scheduler (``inference/scheduler.py``) owns the serving state machine
— admission, chunked prefill / fused decode interleave, retirement,
recompute-preemption — and delegates exactly three decisions to a policy
object:

- :meth:`SchedulingPolicy.select_admission` — WHICH waiting request the
  next admission attempt tries (FIFO: the queue head);
- :meth:`SchedulingPolicy.select_victim` — WHICH running request a
  pool-pressure preemption evicts (FIFO: the latest-admitted);
- :meth:`SchedulingPolicy.admit_ok` — whether a NEW submission is
  accepted at all (admission control: the async front-end consults this
  before enqueueing; a rejection bumps ``serving/rejected_requests`` and
  terminates the request's handle with status ``"rejected"`` instead of
  letting an unbounded queue build under pool pressure);
- :meth:`SchedulingPolicy.select_shed_victim` — WHICH waiting request
  load shedding drops when the always-on loop's queue exceeds
  ``serving.fault.shed_queue_depth`` (default: the lowest-priority
  waiting request, newest arrival on ties — graceful degradation sheds
  the least important, least invested work first).

Determinism contract: every decision is a pure function of scheduler
state that is itself determined by the request trace — arrival order
(``admit_seq`` / queue position), declared ``priority`` / ``ttft_budget``
integers, and the scheduler's LOGICAL step counter (``step_seq``, one
tick per compute action). No wall-clock input: identical request traces
schedule identically across runs and across machines, exactly like the
FIFO pins the serving tests have carried since PR 2. Policies that add
no information (no priorities, no budgets) degrade to FIFO's choices by
construction — their tie-breaks ARE the FIFO rules — which is what lets
the replay tests assert cross-policy agreement on plain traces.

Admission control is shared by every policy (base-class knobs):
``admission_max_queue`` bounds the waiting queue, and
``admission_min_free_blocks`` refuses submissions while the allocator's
free pool (free list + reclaimable cold blocks) is below a floor — both
0 (off) by default, so ``generate_batch``'s closed-loop behavior is
untouched.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union


class SchedulingPolicy:
    """Base policy = the FIFO rules the scheduler has always used.

    Subclasses override the selection hooks; the admission-control knobs
    live here so every policy composes with them. ``admission_max_queue``
    and ``admission_min_free_blocks`` are plain mutable ints by contract:
    the adaptive controller (``monitor/controller.py``) tightens and
    relaxes them at runtime on the serving thread, between engine
    steps."""

    name = "fifo"

    def __init__(self, admission_max_queue: int = 0,
                 admission_min_free_blocks: int = 0):
        if admission_max_queue < 0 or admission_min_free_blocks < 0:
            raise ValueError("admission control knobs must be >= 0 (0 = off)")
        self.admission_max_queue = int(admission_max_queue)
        self.admission_min_free_blocks = int(admission_min_free_blocks)

    # ---- admission control (submission time) ---- #

    def admit_ok(self, sched, prompt_tokens: int) -> bool:
        """Accept or refuse a NEW submission given current pressure.
        Deterministic in scheduler/allocator state. The closed-loop
        ``generate_batch`` path never consults this (its request set is
        fixed up front); the async front-end calls it per submission."""
        if self.admission_max_queue and \
                len(sched.waiting) >= self.admission_max_queue:
            return False
        if self.admission_min_free_blocks and \
                sched.allocator.num_free < self.admission_min_free_blocks:
            return False
        return True

    # ---- scheduling decisions ---- #

    def select_admission(self, sched) -> int:
        """Index into ``sched.waiting`` of the request the next admission
        attempt should try. FIFO: the head."""
        return 0

    def select_victim(self, sched, requester):
        """The running request a pool-pressure preemption evicts.
        FIFO: the latest-admitted (``running[-1]``) — it has the least
        sunk compute and re-queues at the front."""
        return sched.running[-1]

    def select_shed_victim(self, sched) -> Optional[int]:
        """Index into ``sched.waiting`` of the request load shedding
        drops next, or None to refuse (shedding stops). Default: the
        lowest ``priority`` class; within it the NEWEST arrival (``>=``
        over queue order keeps the latest) — under overload the oldest
        waiting work of each class is the closest to being served, so the
        newest goes first. Deterministic in queue state."""
        victim, vp = None, None
        for i, r in enumerate(sched.waiting):
            p = int(getattr(r, "priority", 0))
            if vp is None or p <= vp:
                victim, vp = i, p
        return victim


class FifoPolicy(SchedulingPolicy):
    """The default: explicit name for the base-class FIFO rules."""
    name = "fifo"


class PriorityPolicy(SchedulingPolicy):
    """Strict priority classes. Admission picks the highest-``priority``
    waiting request (ties: earliest submitted — queue order); preemption
    evicts the lowest-priority running request (ties: latest-admitted,
    the FIFO rule). Requests default to priority 0, so a trace with no
    priorities schedules exactly like FIFO."""

    name = "priority"

    def select_admission(self, sched) -> int:
        best, best_p = 0, None
        for i, r in enumerate(sched.waiting):
            p = int(getattr(r, "priority", 0))
            if best_p is None or p > best_p:   # strict >: earliest wins ties
                best, best_p = i, p
        return best

    def select_victim(self, sched, requester):
        victim = sched.running[-1]
        vp = int(getattr(victim, "priority", 0))
        # scan admission-ordered: <= keeps the LATEST-admitted among the
        # lowest class (the FIFO tie-break)
        for r in sched.running:
            if int(getattr(r, "priority", 0)) <= vp:
                victim, vp = r, int(getattr(r, "priority", 0))
        return victim


class SlaPolicy(SchedulingPolicy):
    """SLA-aware scheduling on TTFT slack.

    Each request may declare ``ttft_budget`` — how many scheduler steps
    (the logical ``step_seq`` clock, NOT wall time: replay-deterministic)
    it can wait past its arrival before its first token is late. Slack =
    ``(arrival_step + budget) - step_seq``; a request that has already
    emitted its first token has met its TTFT forever (+inf slack), and a
    request with no budget declares no SLA (+inf as well).

    Preemption evicts the request with the MOST slack — it can best
    afford the recompute delay — instead of FIFO's latest-admitted (ties:
    latest-admitted, so budget-free traces match FIFO exactly). Admission
    is earliest-deadline-first: the waiting request with the LEAST slack
    admits next (ties: queue order = FIFO)."""

    name = "sla"

    def __init__(self, default_ttft_budget: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.default_ttft_budget = default_ttft_budget

    def _slack(self, sched, r) -> float:
        if r.t_first_token is not None:
            return math.inf              # TTFT already met: preferred victim
        budget = r.ttft_budget if r.ttft_budget is not None \
            else self.default_ttft_budget
        if budget is None:
            return math.inf              # no SLA declared
        return (r.arrival_step + int(budget)) - sched.step_seq

    def select_admission(self, sched) -> int:
        best, best_s = 0, None
        for i, r in enumerate(sched.waiting):
            s = self._slack(sched, r)
            if best_s is None or s < best_s:   # strict <: earliest wins ties
                best, best_s = i, s
        return best

    def select_victim(self, sched, requester):
        victim, vs = None, None
        for r in sched.running:        # admission order; >= keeps the latest
            s = self._slack(sched, r)
            if vs is None or s >= vs:
                victim, vs = r, s
        return victim


POLICIES: Dict[str, type] = {p.name: p for p in
                             (FifoPolicy, PriorityPolicy, SlaPolicy)}


def get_policy(spec: Union[None, str, Dict[str, Any], SchedulingPolicy]
               ) -> SchedulingPolicy:
    """Resolve a policy from its config form: an instance (passed
    through), a name (``"fifo" | "priority" | "sla"``), a dict
    (``{"name": ..., **kwargs}`` — kwargs go to the constructor, e.g.
    ``default_ttft_budget`` / ``admission_max_queue`` /
    ``admission_min_free_blocks``), or None (FIFO)."""
    if spec is None:
        return FifoPolicy()
    if isinstance(spec, SchedulingPolicy):
        return spec
    if isinstance(spec, str):
        name, kwargs = spec, {}
    elif isinstance(spec, dict):
        kwargs = {k: v for k, v in spec.items() if k != "name"}
        name = str(spec.get("name", "fifo"))
    else:
        raise ValueError(f"unsupported policy spec {spec!r}")
    cls = POLICIES.get(name)
    if cls is None:
        raise ValueError(f"unknown scheduling policy {name!r} "
                         f"(expected one of {sorted(POLICIES)})")
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise ValueError(f"bad arguments for policy {name!r}: {e}") from None
