"""Continuous-batching scheduler (a copy of
``deepspeed_tpu/inference/scheduler.py``: Orca iteration-level scheduling,
vLLM eviction and prefix caching, Sarathi-style chunked prefill, all host
side). The state machine is kept identical so that one request trace
schedules identically in both packages; the telemetry and flight-recorder
hooks belong to the monitor slice and are left out (``telemetry`` and
``events`` must be None).

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
        if telemetry is not None or events is not None:
            raise NotImplementedError(
                "serving telemetry and the flight recorder are not ported yet: "
                "ROADMAP.md queue 1, telemetry and control plane")
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
        self.telemetry = None
        self.events = None
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
        else:
            req.error = error
            logger.warning(f"request {req.rid} retired: {error}")
            if flavor == "timeout":
                req.timed_out = True
            elif flavor == "shed":
                req.shed = True
        return True

    def requeue_for_retry(self, req: Request, backoff_steps: int, error: str = "") -> None:
        """Re-queue a RUNNING request through the recompute-preemption
        machinery with an admission hold-down of ``backoff_steps`` logical
        steps."""
        if req.state != RUNNING:
            raise ValueError(
                f"request {req.rid} is {req.state}; only RUNNING requests "
                "retry through re-queue")
        self._demote_to_queue(req)
        req.retry_at_step = self.step_seq + max(int(backoff_steps), 0)

    def reset_pool(self, allocator: BlockAllocator) -> None:
        """Swap in a fresh allocator and re-queue ALL running requests from
        prompt + generated tokens, preserving admission order."""
        for req in list(self.running)[::-1]:  # earliest ends at the front
            self._demote_to_queue(req)
        self.allocator = allocator
        self._decode_turn = False

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
            return self._try_admit()

        entries: List[Tuple] = []       # ("dev", b) | ("host", key, k_np, v_np)
        keys: List[bytes] = []
        cow_src: Optional[int] = None
        cow_fetch = None                # (k_np, v_np): host-resident COW src
        cached = 0
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
        if req.pos > 0 or self.chunk_tokens > 0:
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
                    return action
            self.stats["decode_steps"] += 1
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
        bs = self.allocator.block_size
        any_cands = False
        for r in decodable:
            headroom = r.max_new - len(r.generated) - 1
            if headroom <= 0:
                r.spec_tokens = ()
                continue
            cands = self.spec_proposer.propose(r.output, min(self.spec_k, headroom))
            if len(cands):
                need = self.allocator.blocks_for_tokens(
                    r.pos + 1 + len(cands)) - len(r.blocks)
                if need > 0:
                    got = self.allocator.allocate(min(need, self.allocator.num_free_list))
                    if got:
                        r.blocks.extend(got)
                    cands = cands[:len(r.blocks) * bs - 1 - r.pos]
            r.spec_tokens = tuple(int(c) for c in cands)
            if r.spec_tokens:
                any_cands = True
                self.stats["spec_proposed"] += len(r.spec_tokens)
        if not any_cands:
            return None
        self.stats["verify_steps"] += 1
        return ("verify", decodable)

    def _preempt(self, victim: Request) -> None:
        logger.warning(
            f"KV pool exhausted: preempting request {victim.rid} "
            f"({len(victim.blocks)} blocks dereferenced; will recompute "
            f"{len(victim.prefix())} tokens on re-admission"
            + (" minus any prefix-cache hit" if self.prefix_caching else "")
            + ")")
        self.stats["preemptions"] += 1
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
            while len(req.keys) > req.pos // bs:
                key = req.keys.pop()
                self.allocator.unregister_if_owner(req.blocks[len(req.keys)], key)
            keep = max(self.allocator.blocks_for_tokens(req.pos + 1), len(req.keys))
            if len(req.blocks) > keep:
                tail = req.blocks[keep:]
                del req.blocks[keep:]
                self.allocator.free(list(reversed(tail)))
            self.stats["spec_rollbacks"] += 1
        req.generated.append(tokens[-1])
        self.stats["spec_accepted"] += a
        self.stats["emitted_tokens"] += len(tokens)
        for _ in tokens:
            self._record_token_time(req)
        self._maybe_finish(req)

    def _record_token_time(self, req: Request) -> None:
        """TTFT stamp once per request, last-token stamp every token; an
        emitted token is progress, so step-fault retries reset."""
        req.retry_count = 0
        now = time.perf_counter()
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
