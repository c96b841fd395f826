"""Continuous-batching scheduler (a copy of
``deepspeed_tpu/inference/scheduler.py``: Orca iteration-level scheduling,
vLLM eviction and prefix caching, Sarathi-style chunked prefill, all host
side). The state machine is kept identical so that one request trace
schedules identically in both packages, and so are its telemetry hooks
(:class:`ServingTelemetry` into the metrics registry) and flight-recorder
events: the same series and the same event stream for the same trace.

The engine drives one *step* at a time: :meth:`next_action` returns one of

- ``("prefill", request)`` — admit the queue head into freshly allocated
  blocks and run its whole prompt (no prefix hit, chunking off);
- ``("prefill_chunk", request)`` — run the next ``chunk_tokens`` tokens of a
  mid-prefill request against its already-cached blocks (the tail after a
  prefix-cache hit, and chunked prefill);
- ``("decode", running)`` — one fused decode step over every running request
  that finished prefilling;
- ``("verify", running)`` — the speculative form of the decode step
  (``spec_k > 0`` with a proposer);
- ``("wait", None)`` — everything queued is holding down in retry backoff.

Bookkeeping invariant: ``req.pos`` is the number of tokens whose k/v sit in
the pools; the newest generated token (``req.last_token``) is not cached
yet — it is the next decode step's input, written at slot ``pos``. While
prefilling, ``pos < prefill_target == len(prefix())``.

Prefix caching: admission probes the allocator's content-addressed cache,
acquires the hit and allocates only the tail; a fully cached prefix is
capped at ``target - 1`` tokens and restarts mid-block inside a shared
block, which is copied on write (``cow_pending``). Blocks register as they
fill. Preemption is recompute-style: the policy's victim (FIFO: the
latest-admitted) frees its blocks and re-queues at the front with prompt +
generated as its prefix.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.block_allocator import ROOT_KEY, BlockAllocator
from deepspeed_tpu_torch.inference.policy import FifoPolicy
from deepspeed_tpu_torch.utils.logging import logger

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"


class PoolExhausted(RuntimeError):
    """The KV pool cannot supply one more block for ``req`` and there is
    nothing to evict."""

    def __init__(self, msg: str, req: "Request"):
        super().__init__(msg)
        self.req = req


class ServingTelemetry:
    """Registry adapter for the Orca/vLLM-style iteration-level serving
    stats (the JAX package's class, same 41 series): the scheduler calls
    these hooks as its state machine moves and the series land in the
    process-global metrics registry (``deepspeed_tpu_torch.monitor.metrics``).
    The series of what the port does not serve yet (timeouts and shedding
    under deadlines the closed loop never sets, retries, the host KV tier,
    engine restarts) exist and read 0.

    Invariants the tests pin: TTFT is observed exactly ONCE per request —
    the first token after the ORIGINAL arrival, even when a preemption
    forces a re-prefill later — and ``serving/preemptions`` equals the
    number of eviction events (``serving/recompute_tokens`` the prefix
    tokens those evictions will prefill again). With prefix caching,
    ``serving/prefix_cache_hit_tokens`` counts prompt tokens whose prefill
    was SKIPPED via cache hits (hits / lookups is the admission hit rate),
    and ``serving/cold_blocks`` gauges the freed-but-cached pool blocks."""

    _SERIES = ("ttft", "tpot", "queue_wait", "queue_depth", "running",
               "kv_blocks_used",
               "kv_blocks_free", "kv_block_utilization", "kv_fragmentation",
               "cold_blocks", "prefill_steps", "prefill_chunks",
               "decode_steps", "prefix_cache_lookups", "prefix_cache_hits",
               "prefix_cache_hit_tokens",
               "kv_host_blocks", "kv_host_bytes", "kv_spills",
               "kv_fetch_hits", "kv_fetch_tokens", "kv_host_errors",
               "preemptions", "recompute_tokens", "requests", "finished",
               "rejected_requests",
               "generated_tokens", "spec_verify_steps",
               "spec_proposed_tokens", "spec_accepted_tokens",
               "spec_rollbacks", "spec_acceptance_rate", "tp",
               "step_faults", "engine_restarts", "request_retries",
               "timeouts", "shed_requests", "phase_ms", "wasted_tokens")

    def __init__(self, registry=None, replica: str = "r0"):
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        #: replica label stamped on phase/waste observations — mutable,
        #: the router renames engines after construction (set_replica)
        self.replica = replica
        self.ensure()

    def ensure(self) -> None:
        """Pre-create every serving family so zero-valued series (e.g. a
        run with no preemptions) still appear in snapshots. Re-run by the
        scheduler per serve call — re-creates after a registry reset."""
        for name in self._SERIES:
            getattr(self, name)

    # families resolved per access (get-or-create under the registry
    # lock; serving events are host-side per engine step, not a jit hot
    # loop) so a registry reset between bench metrics can't orphan them

    @property
    def ttft(self):
        return self.registry.histogram(
            "serving/ttft_ms", "request arrival -> first generated token")

    @property
    def tpot(self):
        return self.registry.histogram(
            "serving/tpot_ms", "per-output-token latency after the first")

    @property
    def queue_wait(self):
        return self.registry.histogram(
            "serving/queue_wait_ms",
            "request submission -> first admission wait (one observation "
            "per request; preemption re-admissions do not re-observe)")

    @property
    def rejected_requests(self):
        return self.registry.counter(
            "serving/rejected_requests",
            "submissions refused by admission control (queue bound / pool "
            "pressure) before enqueueing")

    @property
    def queue_depth(self):
        return self.registry.gauge(
            "serving/queue_depth", "requests waiting for admission")

    @property
    def running(self):
        return self.registry.gauge(
            "serving/running", "running-batch occupancy (fused decode rows)")

    @property
    def kv_blocks_used(self):
        return self.registry.gauge(
            "serving/kv_blocks_used",
            "pool blocks referenced by live requests (excl. dummy)")

    @property
    def kv_blocks_free(self):
        return self.registry.gauge(
            "serving/kv_blocks_free",
            "allocatable pool blocks: free list + reclaimable cold "
            "(GLOBAL per slice under tensor parallelism — block ids are "
            "shard-invariant, see serving/tp)")

    @property
    def tp(self):
        return self.registry.gauge(
            "serving/tp",
            "tensor-parallel degree of the serving mesh: KV pools are "
            "head-sharded over tp, so block-count gauges are global per "
            "slice while per-shard pool BYTES are 1/tp")

    @property
    def kv_block_utilization(self):
        return self.registry.gauge(
            "serving/kv_block_utilization", "used / allocatable pool blocks")

    @property
    def kv_fragmentation(self):
        return self.registry.gauge(
            "serving/kv_fragmentation",
            "internal fragmentation: unfilled slot fraction of referenced "
            "blocks (capacity minus cached tokens; shared blocks counted "
            "once)")

    @property
    def cold_blocks(self):
        return self.registry.gauge(
            "serving/cold_blocks",
            "freed-but-cached blocks held for prefix reuse (LRU-reclaimed "
            "under allocation pressure)")

    @property
    def prefill_steps(self):
        return self.registry.counter(
            "serving/prefill_steps", "request admissions that scheduled "
            "prefill work (one per admission, however many chunks)")

    @property
    def prefill_chunks(self):
        return self.registry.counter(
            "serving/prefill_chunks",
            "chunked-prefill compute steps (incl. cache-hit tail chunks)")

    @property
    def decode_steps(self):
        return self.registry.counter(
            "serving/decode_steps", "fused decode steps (all rows at once)")

    @property
    def prefix_cache_lookups(self):
        return self.registry.counter(
            "serving/prefix_cache_lookups", "admission-time cache probes")

    @property
    def prefix_cache_hits(self):
        return self.registry.counter(
            "serving/prefix_cache_hits",
            "admission probes that matched at least one full block")

    @property
    def prefix_cache_hit_tokens(self):
        return self.registry.counter(
            "serving/prefix_cache_hit_tokens",
            "prompt tokens whose prefill was skipped via cache hits")

    @property
    def kv_host_blocks(self):
        return self.registry.gauge(
            "serving/kv_host_blocks",
            "demoted KV blocks resident in the host-RAM tier (tiered KV "
            "cache; LRU-bounded by serving.kv_host.max_host_blocks)")

    @property
    def kv_host_bytes(self):
        return self.registry.gauge(
            "serving/kv_host_bytes",
            "host RAM held by demoted KV blocks (k+v slices)")

    @property
    def kv_spills(self):
        return self.registry.counter(
            "serving/kv_spills",
            "cold blocks demoted D2H to the host pool instead of being "
            "destroyed under allocation pressure")

    @property
    def kv_fetch_hits(self):
        return self.registry.counter(
            "serving/kv_fetch_hits",
            "admission prefix probes served from the host tier: demoted "
            "blocks re-materialized H2D instead of recomputed (counted "
            "per block)")

    @property
    def kv_fetch_tokens(self):
        return self.registry.counter(
            "serving/kv_fetch_tokens",
            "prompt tokens whose prefill was skipped via host-tier "
            "fetches (subset of prefix_cache_hit_tokens)")

    @property
    def kv_host_errors(self):
        return self.registry.counter(
            "serving/kv_host_errors",
            "D2H/H2D failures degraded to destroy-on-reclaim / recompute "
            "(allocation errors, injected I/O faults)")

    @property
    def preemptions(self):
        return self.registry.counter(
            "serving/preemptions", "recompute-preempt eviction events")

    @property
    def recompute_tokens(self):
        return self.registry.counter(
            "serving/recompute_tokens",
            "prefix tokens re-prefilled by evictions")

    @property
    def requests(self):
        return self.registry.counter("serving/requests")

    @property
    def finished(self):
        return self.registry.counter("serving/finished_requests")

    @property
    def generated_tokens(self):
        return self.registry.counter("serving/generated_tokens")

    @property
    def spec_verify_steps(self):
        return self.registry.counter(
            "serving/spec_verify_steps",
            "fused speculative verify steps (all rows at once)")

    @property
    def spec_proposed_tokens(self):
        return self.registry.counter(
            "serving/spec_proposed_tokens",
            "candidate tokens proposed by the n-gram speculator")

    @property
    def spec_accepted_tokens(self):
        return self.registry.counter(
            "serving/spec_accepted_tokens",
            "proposed candidates greedy verification accepted")

    @property
    def spec_rollbacks(self):
        return self.registry.counter(
            "serving/spec_rollbacks",
            "verify steps that rejected candidates (pos rewound, "
            "uncommitted prefix-cache registrations withdrawn)")

    @property
    def spec_acceptance_rate(self):
        return self.registry.gauge(
            "serving/spec_acceptance_rate",
            "accepted / proposed candidate tokens (cumulative)")

    # ---- serving-plane fault tolerance (inference/serve.py) ---- #

    @property
    def step_faults(self):
        return self.registry.counter(
            "serving/step_faults",
            "engine-step exceptions contained by the serving loop, by "
            "dispatch site (per-request retry/quarantine or engine "
            "restart — the loop survived either way)", labelnames=("kind",))

    @property
    def engine_restarts(self):
        return self.registry.counter(
            "serving/engine_restarts",
            "crash-safe engine recoveries: pool workspace + fused jits "
            "rebuilt, in-flight requests re-admitted from prompt+generated")

    @property
    def request_retries(self):
        return self.registry.counter(
            "serving/request_retries",
            "per-request fault retries: the faulting action's requests "
            "re-queued through recompute-preemption with logical-step "
            "backoff")

    @property
    def timeouts(self):
        return self.registry.counter(
            "serving/timeouts",
            "requests retired for exceeding their deadline (deadline_ms "
            "wall clock / deadline_steps scheduler clock)")

    @property
    def shed_requests(self):
        return self.registry.counter(
            "serving/shed_requests",
            "queued requests dropped by load shedding under queue "
            "pressure (policy select_shed_victim, lowest priority first)")

    # ---- request latency anatomy (phase ledger) ---- #

    @property
    def phase_ms(self):
        return self.registry.histogram(
            "serving/phase_ms",
            "per-request latency anatomy, one histogram per phase and "
            "replica: TTFT = intake + queue + prefill (+ fetch) + "
            "first decode; TPOT = scheduler wait + decode step. Phases "
            "with device work observe at the recorder's sync points, so "
            "they populate when telemetry.events is on",
            labelnames=("phase", "replica"))

    @property
    def wasted_tokens(self):
        return self.registry.counter(
            "serving/wasted_tokens",
            "tokens whose compute produced no delivered output, by cause: "
            "recompute (preemption re-prefill), spec_reject (verify "
            "rollback), timeout / shed (retired unfinished), failover "
            "(sibling re-derived a failed replica's progress) — the "
            "goodput-vs-throughput gap", labelnames=("cause", "replica"))

    def phase(self, phase: str, ms: float, rid=None) -> None:
        """Observe one phase-ledger sample (exemplar = the request id, so
        a p99 bucket links back to the merged trace's request track)."""
        self.phase_ms.labels(phase=phase, replica=self.replica).observe(
            ms, exemplar={"rid": str(rid)} if rid is not None else None)

    def waste(self, cause: str, n) -> None:
        """Count wasted tokens (``n == 0`` still materializes the series,
        so a fleet scrape shows every cause it is tracking)."""
        self.wasted_tokens.labels(cause=cause,
                                  replica=self.replica).inc(int(n))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [P] int32, immutable
    max_new: int
    eos: Optional[int] = None
    state: str = QUEUED
    blocks: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                    # tokens currently cached in the pools
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_seq: int = -1             # admission stamp (eviction order)
    preemptions: int = 0
    t_arrival: float = 0.0          # perf_counter at add_request
    t_submit: float = 0.0           # perf_counter at submission
    t_first_token: Optional[float] = None   # TTFT stamp (set once, ever)
    t_last_token: float = 0.0       # previous token's stamp (TPOT base)
    trace: Optional[str] = None     # causal trace id (fleet tracing)
    parent: Optional[int] = None    # upstream hop's rid
    priority: int = 0               # PriorityPolicy class (higher = sooner)
    ttft_budget: Optional[int] = None  # SlaPolicy: scheduler steps of TTFT slack
    arrival_step: int = 0           # sched.step_seq at enqueue
    cancelled: bool = False         # retired by cancellation, not eos/max
    deadline_ms: Optional[float] = None   # wall-clock budget from t_submit
    deadline_steps: Optional[int] = None  # logical-step budget
    timed_out: bool = False         # retired by deadline expiry
    shed: bool = False              # dropped by load shedding while queued
    retry_count: int = 0            # per-request step-fault retries so far
    retry_at_step: int = 0          # backoff hold-down on the logical clock
    prefilling: bool = False        # admitted but pos < prefill_target
    prefill_target: int = 0         # len(prefix()) captured at admission
    keys: List[bytes] = dataclasses.field(default_factory=list)
    # chain keys of this request's REGISTERED-or-matched full blocks
    cow_pending: Optional[Tuple[int, int]] = None  # (src, dst) device copy
    # host-tier fetches to land before the next prefill work:
    # (dst_block, chain_key_or_None, k_np, v_np, tokens) per demoted block
    fetch_pending: List[Tuple] = dataclasses.field(default_factory=list)
    error: Optional[str] = None     # set when retired without completing
    spec_tokens: Tuple[int, ...] = ()  # candidates for the pending verify

    def prefix(self) -> np.ndarray:
        """The token prefix a (re)admission must have cached before decode
        resumes: the prompt plus every already-generated token."""
        if not self.generated:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def last_token(self) -> Optional[int]:
        return self.generated[-1] if self.generated else None

    @property
    def output(self) -> np.ndarray:
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])


class ContinuousBatchingScheduler:
    """FIFO admission (with optional prefix-cache probe), chunked prefill
    interleaved with fused decode over all running requests, retire on
    eos/max_new, recompute-preempt the latest-admitted request on OOM."""

    def __init__(self, allocator: BlockAllocator, max_running: int,
                 max_blocks_per_seq: int, telemetry=None,
                 prefix_caching: bool = False, chunk_tokens: int = 0,
                 events=None, rid_base: int = 0,
                 spec_k: int = 0, spec_proposer=None, policy=None):
        if max_running < 1:
            raise ValueError("max_running must be >= 1")
        if chunk_tokens < 0:
            raise ValueError("chunk_tokens must be >= 0 (0 = whole-prompt)")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = speculation off)")
        self.allocator = allocator
        self.max_running = max_running
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_caching = prefix_caching and allocator.prefix_cache
        self.chunk_tokens = chunk_tokens
        self.spec_k = spec_k if spec_proposer is not None else 0
        self.spec_proposer = spec_proposer
        # plain host counters, always on
        self.stats = {"decode_steps": 0, "verify_steps": 0,
                      "emitted_tokens": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_rollbacks": 0,
                      "preemptions": 0}
        self.telemetry = telemetry
        # flight recorder: None when disabled, so every emit site below
        # gates at one None check
        self.events = events
        if telemetry is not None:
            telemetry.ensure()
        self.policy = FifoPolicy() if policy is None else policy
        # logical clock: one tick per compute action handed to the engine
        self.step_seq = 0
        self.waiting: deque = deque()
        self.running: List[Request] = []   # admission-ordered
        self.finished: List[Request] = []
        self._admit_counter = 0
        self._next_rid = int(rid_base)
        # prefill/decode interleave: after a chunk, give decode a turn
        self._decode_turn = False
        # live deadline-carrying requests (the expiry sweep runs only then)
        self._deadline_live = 0

    def _tel_gauges(self) -> None:
        """Refresh the occupancy gauges (queue depth, running rows, KV
        pool utilization) from current scheduler/allocator state, and
        emit the flight-recorder occupancy sample (the serving trace's
        counter-track source) at the same transitions."""
        ev = self.events
        if ev is not None:
            a = self.allocator
            ev.emit("sched.gauge", queued=len(self.waiting),
                    running=len(self.running), kv_used=a.num_used,
                    kv_free=a.num_free)
        t = self.telemetry
        if t is None:
            return
        a = self.allocator
        t.queue_depth.set(len(self.waiting))
        t.running.set(len(self.running))
        used = a.num_used
        t.kv_blocks_used.set(used)
        t.kv_blocks_free.set(a.num_free)
        t.cold_blocks.set(a.num_cold)
        hp = a.host_pool
        if hp is not None:
            t.kv_host_blocks.set(hp.num_blocks)
            t.kv_host_bytes.set(hp.nbytes)
        t.kv_block_utilization.set(used / max(1, a.capacity))
        # internal fragmentation: slots allocated to requests but not yet
        # holding cached k/v (last-block waste + blocks grown ahead of
        # pos). Shared blocks count ONCE (dedup by block id); a mid-prefill
        # request counts its whole target as cached — its blocks are spoken
        # for, not wasted, and the gauge would otherwise spike at admission
        fills = {}
        bs = a.block_size
        for r in self.running:
            c = r.prefill_target if r.prefilling else r.pos
            for j, b in enumerate(r.blocks):
                f = min(bs, max(0, c - j * bs))
                if f > fills.get(b, 0):
                    fills[b] = f
        cap = used * bs
        cached = sum(fills.values())
        t.kv_fragmentation.set(1.0 - cached / cap if cap > 0 else 0.0)

    # ------------------------------------------------------------------ #

    def add_request(self, prompt, max_new: int,
                    eos: Optional[int] = None, priority: int = 0,
                    ttft_budget: Optional[int] = None,
                    t_submit: Optional[float] = None,
                    deadline_ms: Optional[float] = None,
                    deadline_steps: Optional[int] = None,
                    trace: Optional[str] = None,
                    parent: Optional[int] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        total = prompt.size + max_new
        cap = self.max_blocks_per_seq * self.allocator.block_size
        if total > cap:
            raise ValueError(
                f"request needs {total} KV slots but the block table holds "
                f"{cap} ({self.max_blocks_per_seq} blocks of "
                f"{self.allocator.block_size})")
        # admission livelock guard: a prompt that needs more blocks than the
        # pool can EVER supply would sit at the queue head forever
        need = self.allocator.blocks_for_tokens(prompt.size)
        if need > self.allocator.capacity:
            raise ValueError(
                f"prompt of {prompt.size} tokens needs {need} KV blocks but "
                f"the pool only has {self.allocator.capacity} allocatable "
                f"blocks in total — it can never be admitted; raise "
                "serving.max_num_blocks or shorten the prompt")
        now = time.perf_counter()
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      eos=eos, t_arrival=now,
                      t_submit=t_submit if t_submit is not None else now,
                      priority=int(priority),
                      ttft_budget=(None if ttft_budget is None else int(ttft_budget)),
                      deadline_ms=(None if deadline_ms is None else float(deadline_ms)),
                      deadline_steps=(None if deadline_steps is None
                                      else int(deadline_steps)),
                      arrival_step=self.step_seq,
                      trace=(None if trace is None else str(trace)),
                      parent=(None if parent is None else int(parent)))
        self._next_rid += 1
        if req.deadline_ms is not None or req.deadline_steps is not None:
            self._deadline_live += 1
        self.waiting.append(req)
        if self.events is not None:
            # the trace context rides the enqueue (the fleet renderer's
            # flow-arrow source)
            ctx = {}
            if req.trace is not None:
                ctx["trace"] = req.trace
            if req.parent is not None:
                ctx["parent"] = req.parent
            self.events.emit("req.enqueue", rid=req.rid,
                             prompt_tokens=int(prompt.size),
                             max_new=max_new, **ctx)
        if self.telemetry is not None:
            self.telemetry.requests.inc()
        self._tel_gauges()
        return req

    def all_done(self) -> bool:
        return not self.waiting and not self.running

    def _deadline_retired(self, req: Request) -> None:
        if req.deadline_ms is not None or req.deadline_steps is not None:
            self._deadline_live -= 1

    def cancel_request(self, req: Request) -> bool:
        """Retire ``req`` by cancellation at any lifecycle point (between
        scheduler actions). Returns False when it had already finished."""
        return self._force_retire(req, error=None)

    def fail_request(self, req: Request, error: str) -> bool:
        """Retire ``req`` with ``error`` at any lifecycle point."""
        return self._force_retire(req, error=str(error))

    def timeout_request(self, req: Request, error: str) -> bool:
        """Retire ``req`` as a deadline expiry (``req.timed_out``)."""
        return self._force_retire(req, error=str(error), flavor="timeout")

    def shed_request(self, req: Request) -> bool:
        """Drop a QUEUED ``req`` under load-shedding pressure."""
        if req.state != QUEUED:
            raise ValueError(
                f"request {req.rid} is {req.state}; only QUEUED requests "
                "can be shed")
        return self._force_retire(req, error="shed under queue pressure", flavor="shed")

    def _force_retire(self, req: Request, error: Optional[str],
                      flavor: str = "error") -> bool:
        if req.state == FINISHED:
            return False
        if req.state == QUEUED:
            for i, r in enumerate(self.waiting):   # identity, not __eq__
                if r is req:
                    del self.waiting[i]
                    break
            else:
                raise ValueError(f"request {req.rid} is QUEUED but not in "
                                 "this scheduler's waiting queue")
        else:
            self.running.remove(req)
            self._free_blocks(req)
        req.spec_tokens = ()
        req.state = FINISHED
        self._deadline_retired(req)
        self.finished.append(req)
        if error is None:
            req.cancelled = True
            if self.events is not None:
                self.events.emit("req.cancel", rid=req.rid,
                                 generated=len(req.generated))
        else:
            req.error = error
            logger.warning(f"request {req.rid} retired: {error}")
            if flavor == "timeout":
                req.timed_out = True
                if self.telemetry is not None:
                    self.telemetry.timeouts.inc()
                    self.telemetry.waste("timeout", len(req.generated))
                if self.events is not None:
                    self.events.emit("req.timeout", rid=req.rid,
                                     generated=len(req.generated), error=error)
            elif flavor == "shed":
                req.shed = True
                if self.telemetry is not None:
                    self.telemetry.shed_requests.inc()
                    self.telemetry.waste("shed", len(req.generated))
                if self.events is not None:
                    self.events.emit("req.shed", rid=req.rid, priority=req.priority)
            elif self.events is not None:
                self.events.emit("req.retire", rid=req.rid,
                                 generated=len(req.generated), error=error)
        if self.telemetry is not None:
            self.telemetry.finished.inc()
        self._tel_gauges()
        return True

    def requeue_for_retry(self, req: Request, backoff_steps: int, error: str = "") -> None:
        """Re-queue a RUNNING request through the recompute-preemption
        machinery with an admission hold-down of ``backoff_steps`` logical
        steps."""
        if req.state != RUNNING:
            raise ValueError(
                f"request {req.rid} is {req.state}; only RUNNING requests "
                "retry through re-queue")
        if self.events is not None:
            self.events.emit("req.requeue", rid=req.rid, retry=req.retry_count,
                             backoff_steps=int(backoff_steps), error=error)
        if self.telemetry is not None:
            self.telemetry.request_retries.inc()
        self._demote_to_queue(req)
        req.retry_at_step = self.step_seq + max(int(backoff_steps), 0)
        self._tel_gauges()

    def reset_pool(self, allocator: BlockAllocator) -> None:
        """Swap in a fresh allocator and re-queue ALL running requests from
        prompt + generated tokens, preserving admission order."""
        for req in list(self.running)[::-1]:  # earliest ends at the front
            self._demote_to_queue(req)
        self.allocator = allocator
        self._decode_turn = False
        self._tel_gauges()

    def _demote_to_queue(self, req: Request) -> None:
        """The ONE RUNNING -> QUEUED demotion (preemption, retry, restart)."""
        self.running.remove(req)
        self._free_blocks(req)
        req.pos = 0
        req.prefilling = False
        req.prefill_target = 0
        req.spec_tokens = ()
        req.state = QUEUED
        self.waiting.appendleft(req)

    # ------------------------------------------------------------------ #
    # admission

    def _try_admit(self) -> Optional[Tuple[str, Request]]:
        """Admit the policy's pick when a slot and its (tail) blocks are
        available: probe the prefix cache, acquire the hit, allocate only
        the rest, and start the request's ``pos`` past the cached tokens."""
        if not self.waiting or len(self.running) >= self.max_running:
            return None
        idx = int(self.policy.select_admission(self))
        if not 0 <= idx < len(self.waiting):
            raise ValueError(
                f"policy {self.policy.name!r} selected waiting index {idx} "
                f"out of range (queue depth {len(self.waiting)})")
        req = self.waiting[idx]
        if req.retry_at_step > self.step_seq:
            # the pick is holding down after a retry: take the first eligible
            # waiting request in FIFO order instead, or admit nothing
            for j, r in enumerate(self.waiting):
                if r.retry_at_step <= self.step_seq:
                    idx, req = j, r
                    break
            else:
                return None
        prefix = req.prefix()
        target = int(prefix.size)
        bs = self.allocator.block_size
        need_total = self.allocator.blocks_for_tokens(target)
        if need_total > self.allocator.capacity:
            # preemption-appended tokens grew the prefix past the whole pool
            del self.waiting[idx]
            req.state = FINISHED
            self._deadline_retired(req)
            req.error = (
                f"prefix of {target} tokens (prompt + {len(req.generated)} "
                f"generated) needs {need_total} KV blocks but the pool has "
                f"{self.allocator.capacity}; raise serving.max_num_blocks")
            logger.warning(f"request {req.rid} retired: {req.error}")
            self.finished.append(req)
            if self.events is not None:
                self.events.emit("req.retire", rid=req.rid,
                                 generated=len(req.generated), error=req.error)
            if self.telemetry is not None:
                self.telemetry.finished.inc()
            self._tel_gauges()
            return self._try_admit()

        entries: List[Tuple] = []       # ("dev", b) | ("host", key, k_np, v_np)
        keys: List[bytes] = []
        cow_src: Optional[int] = None
        cow_fetch = None                # (k_np, v_np): host-resident COW src
        cached = 0
        had_hit = False
        if self.prefix_caching:
            hits, hit_keys = self.allocator.match_prefix_tiered(prefix)
            resolved: List[Tuple] = []
            for ent, key in zip(hits, hit_keys):
                if ent[0] == "dev":
                    resolved.append((ent, key))
                    continue
                data = self.allocator.host_pool.get(ent[1])
                if data is None:
                    break
                resolved.append((("host", ent[1], data[0], data[1]), key))
            had_hit = bool(resolved)
            if self.telemetry is not None:
                self.telemetry.prefix_cache_lookups.inc()
                if resolved:
                    self.telemetry.prefix_cache_hits.inc()
            cached = len(resolved) * bs
            if cached >= target:
                # full prefix cached: cap the hit at target-1 and copy-on-write
                # the last shared block (partial blocks are never shared)
                cached = target - 1
                last, _ = resolved[-1]
                resolved = resolved[:-1]
                if last[0] == "dev":
                    cow_src = last[1]
                else:
                    cow_fetch = (last[2], last[3])
            entries = [e for e, _ in resolved]
            keys = [k for _, k in resolved]

        shared = [e[1] for e in entries if e[0] == "dev"]
        alloc_needed = need_total - len(shared)
        # acquire the hit FIRST so the tail allocation's cold-list reclaim
        # can't cannibalize the very blocks we are about to share
        self.allocator.acquire(shared)
        protect_cow = cow_src is not None and any(e[0] == "host" for e in entries)
        if protect_cow:
            self.allocator.acquire([cow_src])
        got = self.allocator.allocate(alloc_needed)
        if got is None and protect_cow:
            self.allocator.free([cow_src])
            cow_src = None
            protect_cow = False
            cached = bs * len(entries)
            got = self.allocator.allocate(alloc_needed)
        if got is None:
            # roll the probe back in REVERSE, so LRU reclaims chain tails first
            self.allocator.free(list(reversed(shared)))
            if not self.running:
                raise PoolExhausted(
                    f"prefix of request {req.rid} needs {alloc_needed} more "
                    f"KV blocks but the pool only has "
                    f"{self.allocator.num_free} available and nothing is "
                    "running to evict; raise serving.max_num_blocks or "
                    "shrink the prompt", req)
            return None

        it = iter(got)
        blocks: List[int] = []
        fetches: List[Tuple] = []
        for e in entries:
            if e[0] == "dev":
                blocks.append(e[1])
            else:
                dst = next(it)
                blocks.append(dst)
                fetches.append((dst, e[1], e[2], e[3], bs))
        tail = list(it)
        blocks += tail
        if protect_cow:
            self.allocator.free([cow_src])
        if cow_fetch is not None:
            fetches.append((tail[0], None, cow_fetch[0], cow_fetch[1],
                            cached - bs * len(entries)))

        del self.waiting[idx]
        first_admit = req.admit_seq == -1
        if self.telemetry is not None and first_admit:
            # first admission only: the submit->admit wait (a preemption
            # re-admission is recompute latency, not queueing delay)
            now = time.perf_counter()
            self.telemetry.queue_wait.observe((now - req.t_submit) * 1e3,
                                              exemplar={"rid": str(req.rid)})
            self.telemetry.phase("intake", max(req.t_arrival - req.t_submit, 0.0) * 1e3,
                                 rid=req.rid)
            self.telemetry.phase("queue", max(now - req.t_arrival, 0.0) * 1e3, rid=req.rid)
        req.blocks = blocks
        req.keys = list(keys)
        req.pos = cached
        req.prefill_target = target
        req.prefilling = True
        req.cow_pending = None if cow_src is None else (cow_src, tail[0])
        req.fetch_pending = fetches
        req.state = RUNNING
        req.admit_seq = self._admit_counter
        self._admit_counter += 1
        self.running.append(req)
        if self.events is not None:
            # probe outcome emitted only on the admission that sticks
            if self.prefix_caching:
                if had_hit:
                    self.events.emit("req.cache_hit", rid=req.rid, tokens=cached,
                                     host_blocks=len(fetches))
                else:
                    self.events.emit("req.cache_miss", rid=req.rid)
            self.events.emit("req.admit", rid=req.rid, cached_tokens=cached,
                             blocks=len(req.blocks), prefill_target=target)
            if first_admit:
                # the pre-admission phases: already-elapsed intervals ending here
                now_ns = time.monotonic_ns()
                self.events.emit(
                    "req.phase", rid=req.rid, t_ns=now_ns, phase="intake",
                    dur_ns=int(max(req.t_arrival - req.t_submit, 0.0) * 1e9))
                self.events.emit(
                    "req.phase", rid=req.rid, t_ns=now_ns, phase="queue",
                    dur_ns=int(max(time.perf_counter() - req.t_arrival, 0.0) * 1e9))
        if self.telemetry is not None:
            self.telemetry.prefill_steps.inc()
            if cached:
                self.telemetry.prefix_cache_hit_tokens.inc(cached)
        self._tel_gauges()
        if req.pos > 0 or self.chunk_tokens > 0:
            if self.telemetry is not None:
                self.telemetry.prefill_chunks.inc()
            self._decode_turn = True
            return ("prefill_chunk", req)
        return ("prefill", req)

    # ------------------------------------------------------------------ #

    def next_action(self) -> Optional[Tuple[str, object]]:
        """Pick the next engine step: admission first (back-fill freed slots
        immediately), else alternate one prefill chunk of the oldest
        mid-prefill request with one fused decode step. None when everything
        is finished. Every returned action ticks the logical ``step_seq``."""
        if self._deadline_live:
            self._sweep_deadlines()
        action = self._next_action()
        if action is not None:
            self.step_seq += 1
        return action

    def _sweep_deadlines(self) -> None:
        now = None
        for req in list(self.waiting) + list(self.running):
            expired = None
            if req.deadline_steps is not None and \
                    self.step_seq - req.arrival_step >= req.deadline_steps:
                expired = f"deadline of {req.deadline_steps} scheduler steps exceeded"
            elif req.deadline_ms is not None:
                if now is None:
                    now = time.perf_counter()
                waited_ms = (now - req.t_submit) * 1e3
                if waited_ms > req.deadline_ms:
                    expired = (f"deadline of {req.deadline_ms:.0f} ms exceeded "
                               f"({waited_ms:.0f} ms since submission)")
            if expired is not None:
                self.timeout_request(req, expired)

    def _next_action(self) -> Optional[Tuple[str, object]]:
        action = self._try_admit()
        if action is not None:
            return action
        prefilling = [r for r in self.running if r.prefilling]
        decodable = [r for r in self.running if not r.prefilling]
        if prefilling and (not decodable or not self._decode_turn):
            if self.telemetry is not None:
                self.telemetry.prefill_chunks.inc()
            self._decode_turn = True
            return ("prefill_chunk", prefilling[0])
        if decodable:
            self._decode_turn = False
            self._ensure_decode_capacity()
            decodable = [r for r in self.running if not r.prefilling]
            if not decodable:
                # capacity growth evicted every decodable row: pick again
                return self._next_action()
            if self.spec_k > 0:
                action = self._prepare_verify(decodable)
                if action is not None:
                    self._tel_gauges()   # window growth moved blocks
                    return action
            self.stats["decode_steps"] += 1
            if self.telemetry is not None:
                self.telemetry.decode_steps.inc()
            self._tel_gauges()           # capacity growth/evictions moved blocks
            return ("decode", decodable)
        if self.waiting:
            if all(r.retry_at_step > self.step_seq for r in self.waiting):
                return ("wait", None)
            raise RuntimeError("scheduler stuck: waiting requests but nothing runnable")
        return None

    def _ensure_decode_capacity(self) -> None:
        """Every decode-ready request writes its next token at slot ``pos``;
        grow its block list when that slot crosses a block boundary,
        evicting the policy's victim when the pool is dry."""
        for req in list(self.running):
            if req.state != RUNNING or req.prefilling:
                continue
            while req.pos >= len(req.blocks) * self.allocator.block_size:
                got = self.allocator.allocate(1)
                if got is not None:
                    req.blocks.extend(got)
                    break
                victim = self.policy.select_victim(self, req)
                if not any(victim is r for r in self.running):
                    raise ValueError(
                        f"policy {self.policy.name!r} selected a victim "
                        "that is not running")
                if victim is req and len(self.running) == 1:
                    raise PoolExhausted(
                        f"request {req.rid} needs one more KV block but the "
                        "pool is exhausted and it is the only running "
                        "request; raise serving.max_num_blocks", req)
                self._preempt(victim)
                if victim is req:
                    break  # the requester evicted itself; it re-queued

    def _prepare_verify(self, decodable: List[Request]) -> Optional[Tuple[str, object]]:
        """Propose candidates for every decode-ready request and secure the
        KV slots their verify windows write, from the plain free list only
        (speculation never preempts nor reclaims cached blocks). None when
        no request found a match."""
        ev = self.events
        bs = self.allocator.block_size
        any_cands = False
        for r in decodable:
            headroom = r.max_new - len(r.generated) - 1
            if headroom <= 0:
                r.spec_tokens = ()
                continue
            t0 = time.monotonic_ns() if ev is not None else 0
            cands = self.spec_proposer.propose(r.output, min(self.spec_k, headroom))
            found = len(cands)
            if len(cands):
                need = self.allocator.blocks_for_tokens(
                    r.pos + 1 + len(cands)) - len(r.blocks)
                if need > 0:
                    got = self.allocator.allocate(min(need, self.allocator.num_free_list))
                    if got:
                        r.blocks.extend(got)
                    cands = cands[:len(r.blocks) * bs - 1 - r.pos]
            r.spec_tokens = tuple(int(c) for c in cands)
            # emitted only when the proposer matched (a zero-found probe per
            # request per decode turn would flood the bounded ring)
            if ev is not None and found:
                ev.emit("req.spec_propose", rid=r.rid, t_ns=t0,
                        dur_ns=time.monotonic_ns() - t0,
                        tokens=len(r.spec_tokens), found=found)
            if r.spec_tokens:
                any_cands = True
                self.stats["spec_proposed"] += len(r.spec_tokens)
                if self.telemetry is not None:
                    self.telemetry.spec_proposed_tokens.inc(len(r.spec_tokens))
        if not any_cands:
            return None
        self.stats["verify_steps"] += 1
        if self.telemetry is not None:
            self.telemetry.spec_verify_steps.inc()
        return ("verify", decodable)

    def _preempt(self, victim: Request) -> None:
        logger.warning(
            f"KV pool exhausted: preempting request {victim.rid} "
            f"({len(victim.blocks)} blocks dereferenced; will recompute "
            f"{len(victim.prefix())} tokens on re-admission"
            + (" minus any prefix-cache hit" if self.prefix_caching else "")
            + ")")
        if self.events is not None:
            self.events.emit("req.preempt", rid=victim.rid, blocks=len(victim.blocks),
                             recompute_tokens=len(victim.prefix()))
        self.stats["preemptions"] += 1
        if self.telemetry is not None:
            self.telemetry.preemptions.inc()
            self.telemetry.recompute_tokens.inc(len(victim.prefix()))
            # the evicted prefix is compute the pool pressure threw away
            self.telemetry.waste("recompute", len(victim.prefix()))
        self._demote_to_queue(victim)
        victim.preemptions += 1

    def _free_blocks(self, req: Request) -> None:
        """Dereference a retiring/preempted request's blocks, in REVERSE when
        caching so the LRU cold list reclaims chain tails before parents."""
        blocks = req.blocks
        if self.prefix_caching:
            blocks = list(reversed(blocks))
        self.allocator.free(blocks)
        req.blocks = []
        req.keys = []
        req.cow_pending = None
        req.fetch_pending = []

    def _register_full_blocks(self, req: Request) -> None:
        """Publish every newly-FILLED block into the content-addressed
        cache, extending the request's hash chain (first-writer-wins)."""
        if not self.prefix_caching:
            return
        bs = self.allocator.block_size
        full = req.pos // bs
        if full <= len(req.keys):
            return
        seq = req.prefix()
        parent = req.keys[-1] if req.keys else ROOT_KEY
        for j in range(len(req.keys), full):
            key = self.allocator.chain_key(parent, seq[j * bs:(j + 1) * bs])
            self.allocator.register(req.blocks[j], key)
            req.keys.append(key)
            parent = key

    # ------------------------------------------------------------------ #
    # engine callbacks after each compute step

    def record_prefill(self, req: Request, token: int) -> None:
        """The engine prefilled ``req.prefix()`` whole and sampled ``token``."""
        req.pos = len(req.prefix())
        req.prefilling = False
        self._register_full_blocks(req)
        req.generated.append(int(token))
        self._record_token_time(req)
        self._maybe_finish(req)

    def record_prefill_chunk(self, req: Request, n_tokens: int,
                             token: Optional[int] = None) -> None:
        """One prefill chunk of ``n_tokens`` is cached; the FINAL chunk
        passes the sampled ``token``."""
        req.pos += int(n_tokens)
        if req.pos > req.prefill_target:
            raise ValueError(
                f"prefill chunk overran request {req.rid}: pos {req.pos} > "
                f"target {req.prefill_target}")
        self._register_full_blocks(req)
        if token is None:
            return
        if req.pos != req.prefill_target:
            raise ValueError(
                f"request {req.rid} sampled a token at pos {req.pos} before "
                f"reaching its prefill target {req.prefill_target}")
        req.prefilling = False
        req.generated.append(int(token))
        self._record_token_time(req)
        self._maybe_finish(req)

    def record_decode(self, req: Request, token: int) -> None:
        """One decode step: ``last_token``'s k/v landed at slot ``pos`` and
        ``token`` was sampled from the resulting logits."""
        req.pos += 1
        self._register_full_blocks(req)
        req.generated.append(int(token))
        self.stats["emitted_tokens"] += 1
        self._record_token_time(req)
        self._maybe_finish(req)

    def record_verify(self, req: Request, tokens: List[int]) -> None:
        """One fused verify step for ``req``: advance over the whole
        scattered window, then roll back the rejected candidates (pos
        rewind, registrations withdrawn, surplus blocks returned)."""
        cands = req.spec_tokens
        m = len(cands)
        req.spec_tokens = ()
        tokens = [int(t) for t in tokens]
        if not 1 <= len(tokens) <= m + 1:
            raise ValueError(
                f"verify of request {req.rid} emitted {len(tokens)} tokens "
                f"from a window of {m} candidates")
        if req.eos is not None and req.eos in tokens:
            tokens = tokens[:tokens.index(req.eos) + 1]
        a = len(tokens) - 1            # candidates that commit
        req.generated.extend(int(c) for c in cands)
        req.pos += m + 1
        self._register_full_blocks(req)
        drop = m - a
        if drop:
            req.pos -= drop
            del req.generated[-drop:]
            bs = self.allocator.block_size
            unregistered = 0
            while len(req.keys) > req.pos // bs:
                key = req.keys.pop()
                if self.allocator.unregister_if_owner(req.blocks[len(req.keys)], key):
                    unregistered += 1
            keep = max(self.allocator.blocks_for_tokens(req.pos + 1), len(req.keys))
            if len(req.blocks) > keep:
                tail = req.blocks[keep:]
                del req.blocks[keep:]
                self.allocator.free(list(reversed(tail)))
            self.stats["spec_rollbacks"] += 1
            if self.telemetry is not None:
                self.telemetry.spec_rollbacks.inc()
                # rejected candidates were verified on the device, then dropped
                self.telemetry.waste("spec_reject", drop)
            if self.events is not None:
                self.events.emit("req.spec_rollback", rid=req.rid, rejected=drop,
                                 unregistered=unregistered)
        req.generated.append(tokens[-1])
        self.stats["spec_accepted"] += a
        self.stats["emitted_tokens"] += len(tokens)
        if self.telemetry is not None:
            t = self.telemetry
            t.spec_accepted_tokens.inc(a)
            # from the CUMULATIVE registry counters, so the gauge always
            # equals accepted/proposed as the snapshot reports them
            proposed = t.spec_proposed_tokens.value
            if proposed:
                t.spec_acceptance_rate.set(t.spec_accepted_tokens.value / proposed)
        for _ in tokens:
            self._record_token_time(req)
        self._maybe_finish(req)

    def _record_token_time(self, req: Request) -> None:
        """TTFT stamp once per request, last-token stamp every token; an
        emitted token is progress, so step-fault retries reset."""
        req.retry_count = 0
        now = time.perf_counter()
        t = self.telemetry
        if t is not None:
            # TTFT once per request (the first token after the ORIGINAL
            # arrival), TPOT for every token after it; the exemplar links a
            # histogram bucket back to the request's trace track
            if req.t_first_token is None:
                t.ttft.observe((now - req.t_arrival) * 1e3, exemplar={"rid": str(req.rid)})
            else:
                t.tpot.observe((now - req.t_last_token) * 1e3, exemplar={"rid": str(req.rid)})
            t.generated_tokens.inc()
        if req.t_first_token is None:
            req.t_first_token = now
        req.t_last_token = now

    def _maybe_finish(self, req: Request) -> None:
        done = len(req.generated) >= req.max_new
        if req.eos is not None and req.generated[-1] == req.eos:
            done = True
        if done:
            req.state = FINISHED
            self._deadline_retired(req)
            self.running.remove(req)
            self._free_blocks(req)
            self.finished.append(req)
            if self.events is not None:
                self.events.emit("req.retire", rid=req.rid, generated=len(req.generated),
                                 preemptions=req.preemptions)
            if self.telemetry is not None:
                self.telemetry.finished.inc()
            self._tel_gauges()
