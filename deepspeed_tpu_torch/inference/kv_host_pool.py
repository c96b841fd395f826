"""Host-memory KV tier behind the paged block allocator (the tiered KV cache
of ``deepspeed_tpu/inference/kv_host_pool.py``).

Reclaiming a cold prefix-cache block destroys content a returning user
would re-hit. With the tier on, the allocator demotes the block here
instead: the session gathers its per-layer ``[L, bs, KV, Hd]`` k and v
slices and the pool copies them to host RAM, keyed by the block's blake2b
hash chain (the content address the device table uses). A later admission
whose prefix walks onto a demoted chain copies the block back into a fresh
device block (``engine._ServeSession._run_fetches``) instead of recomputing
its prefill.

Tier discipline (the same as the JAX pool's):

- a chain key lives in at most one tier: a host entry is removed when its
  content is fetched back onto a device block, and discarded when a device
  registration lands under the same key;
- the pool holds at most ``max_blocks`` entries with its own LRU: a ``put``
  over capacity evicts the oldest (host eviction loses only a cache copy);
- entries are immutable: the bytes under a content address never change.

Copies on the card. ``put`` takes the session's gather (a device clone of
the block, queued on the serving stream before the reclaiming owner's
writes) and starts its D2H copy into a pinned staging buffer on a copy
stream of the pool's own, which waits on the serving stream first. The
pending queue (``pending_limit``) bounds how many gathers and staging
buffers are in flight: past it, the oldest entry is materialized (its copy
event waited on, its bytes moved into a pageable CPU tensor, the gather and
the staging buffer released). ``get`` materializes on demand. Entries are
torch CPU tensors of the pool's dtype (numpy has no bf16), so a fetched
block is bit-equal to the spilled one. On the CPU the gather already is a
host tensor and materializing moves nothing.

Fault injection: every spill and fetch consults
``utils.fault_injection.guarded_io`` under the virtual paths
``kv_host_pool/spill`` and ``kv_host_pool/fetch``. An ``OSError`` degrades:
a faulted ``put`` skips the spill (destroy-on-reclaim), a faulted ``get``
drops the entry and reports a miss (the admission recomputes the block),
with a warning and the ``serving/kv_host_errors`` counter.
``SimulatedCrash`` propagates.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

import torch

from deepspeed_tpu_torch.accelerator import abstract_accelerator as _acc
from deepspeed_tpu_torch.utils import fault_injection as _fi
from deepspeed_tpu_torch.utils.logging import warn_once


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the pool's dtype tag, the JAX
    pool's numpy / ml_dtypes name for the same type."""
    return str(dtype).replace("torch.", "")


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


class _HostBlock:
    """One demoted block: k and v slices ``[L, bs, KV, Hd]``. Until
    :meth:`materialize` runs on the card they are the gather's device
    clones with a D2H copy into pinned staging in flight; after, pageable
    CPU tensors."""

    __slots__ = ("k", "v", "nbytes", "pending", "_staged", "_done")

    def __init__(self, k, v, staged=None, done=None):
        self.k = k
        self.v = v
        self.nbytes = _nbytes(k) + _nbytes(v)
        self.pending = True
        self._staged = staged        # (k_pin, v_pin) the copy stream fills
        self._done = done            # CUDA event recorded after the copies

    def materialize(self) -> None:
        if not self.pending:
            return
        if self._staged is not None:
            _acc.syncs += 1          # a host wait on the device, as to_host counts it
            self._done.synchronize()
            k_pin, v_pin = self._staged
            self.k = torch.empty(k_pin.shape, dtype=k_pin.dtype).copy_(k_pin)
            self.v = torch.empty(v_pin.shape, dtype=v_pin.dtype).copy_(v_pin)
            self._staged = self._done = None
        self.pending = False


class KvHostPool:
    """LRU-bounded host pool of demoted KV blocks, keyed by the allocator's
    content-address chain keys. Thread-safe: replicas on one card share one
    pool from their own serving threads, and telemetry reads the gauges."""

    def __init__(self, max_blocks: int, block_shape: Tuple[int, ...],
                 dtype: str, pending_limit: int = 4, telemetry=None):
        if max_blocks < 1:
            raise ValueError("max_blocks must be >= 1")
        if len(block_shape) != 4:
            raise ValueError("block_shape must be [L, bs, KV, Hd], got "
                             f"{block_shape}")
        self.max_blocks = int(max_blocks)
        self.block_shape = tuple(int(s) for s in block_shape)
        self.dtype = dtype_name(dtype)
        # in-flight D2H copies: at most pending_limit gathers and staging
        # buffers held before the oldest is forced down to host RAM
        self.pending_limit = max(int(pending_limit), 1)
        self.telemetry = telemetry
        self._lock = threading.RLock()
        self._entries: "OrderedDict[bytes, _HostBlock]" = OrderedDict()
        self._pending: deque = deque()           # keys awaiting materialize
        self._nbytes = 0
        self._copy_streams = {}                  # CUDA device index -> stream
        # plain host counters, always on (tests and the fault-degradation
        # path read these with the metrics registry off too)
        self.stats = {"spills": 0, "fetches": 0, "evictions": 0, "errors": 0}

    # ------------------------------------------------------------------ #
    # capacity / introspection

    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def contains(self, key: bytes) -> bool:
        """Read-only probe (no LRU refresh): the allocator's tiered match
        walk uses it so probing never reorders eviction."""
        with self._lock:
            return key in self._entries

    def keys(self) -> List[bytes]:
        with self._lock:
            return list(self._entries)

    def matches_geometry(self, block_shape, dtype) -> bool:
        """Entries are valid for one ``[L, bs, KV, Hd]`` and dtype: the
        engine rebuilds the pool when its serving geometry changes."""
        return (self.block_shape == tuple(int(s) for s in block_shape)
                and self.dtype == dtype_name(dtype))

    # ------------------------------------------------------------------ #
    # tier transitions

    def _count_error(self, what: str, err: Exception) -> None:
        self.stats["errors"] += 1
        if self.telemetry is not None:
            self.telemetry.kv_host_errors.inc()
        warn_once(f"KV host pool {what} failed ({err}); degrading to "
                  "destroy-on-reclaim for the affected block(s): serving "
                  "continues, the content will be recomputed on re-hit")

    def _stage(self, k_dev, v_dev):
        """Start the D2H copies of a device gather into pinned staging on
        the pool's copy stream, ordered after the serving stream's work so
        far (the gather included). Returns ``(staged, done_event)``."""
        dev = k_dev.device
        stream = self._copy_streams.get(dev.index)
        if stream is None:
            stream = self._copy_streams[dev.index] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            staged = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                           .copy_(t, non_blocking=True) for t in (k_dev, v_dev))
            done = torch.cuda.Event()
            done.record(stream)
        return staged, done

    def put(self, key: bytes, k_dev, v_dev) -> bool:
        """Demote one block: keep the gathered slices and start their host
        copies. Returns True when a new entry was stored (the caller counts
        a spill); a duplicate key only refreshes LRU recency. Over-capacity
        puts evict the LRU tail. Injected I/O faults degrade to a no-op
        (destroy-on-reclaim)."""
        if tuple(k_dev.shape) != self.block_shape:
            raise ValueError(
                f"demoted slice shape {tuple(k_dev.shape)} does not match "
                f"the pool geometry {self.block_shape}")
        nbytes = _nbytes(k_dev) + _nbytes(v_dev)
        try:
            _fi.guarded_io("kv_host_pool/spill", nbytes)
        except OSError as e:                      # SimulatedCrash propagates
            self._count_error("spill (D2H)", e)
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            # make room in the in-flight window before starting a copy
            while len(self._pending) >= self.pending_limit:
                old = self._entries.get(self._pending.popleft())
                if old is not None:
                    old.materialize()
            if k_dev.device.type == "cuda":
                ent = _HostBlock(k_dev, v_dev, *self._stage(k_dev, v_dev))
            else:
                ent = _HostBlock(k_dev, v_dev)
            self._entries[key] = ent
            self._nbytes += ent.nbytes
            self._pending.append(key)
            while len(self._entries) > self.max_blocks:
                _, dropped = self._entries.popitem(last=False)   # LRU
                self._nbytes -= dropped.nbytes
                self.stats["evictions"] += 1
        return True

    def get(self, key: bytes) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Materialized CPU ``(k, v)`` for a host hit (LRU refreshed), or
        None on a miss. The entry stays in the pool: the scheduler calls
        :meth:`remove` only once the fetch has landed on the device, so a
        preemption between admission and fetch loses nothing. A fault drops
        the entry and reports a miss (the admission recomputes the block)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            try:
                _fi.guarded_io("kv_host_pool/fetch", ent.nbytes)
                ent.materialize()
            except Exception as e:
                # an injected OSError and real failures (a host allocation,
                # a device error surfacing at the copy's event) degrade to a
                # miss; only SimulatedCrash (a BaseException) propagates
                del self._entries[key]
                self._nbytes -= ent.nbytes
                self._count_error("fetch (H2D)", e)
                return None
            self._entries.move_to_end(key)
            self.stats["fetches"] += 1
            return ent.k, ent.v

    def remove(self, key: bytes) -> bool:
        """Drop an entry (its content is back on a device block: a chain key
        lives in at most one tier). No-op on a miss."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return False
            self._nbytes -= ent.nbytes
            return True

    discard = remove   # a device registration superseding the host copy

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pending.clear()
            self._nbytes = 0

    def drain(self) -> None:
        """Force every in-flight copy down to host RAM (a test and shutdown
        barrier; steady state bounds itself through ``pending_limit``)."""
        with self._lock:
            for ent in self._entries.values():
                ent.materialize()
            self._pending.clear()

    # ------------------------------------------------------------------ #
    # invariants

    def consistency_report(self) -> List[str]:
        """Internal-invariant violations (empty = consistent): the LRU is
        within its bound, byte accounting matches the entries, and every
        entry carries the pool geometry."""
        probs: List[str] = []
        with self._lock:
            if len(self._entries) > self.max_blocks:
                probs.append(
                    f"host pool holds {len(self._entries)} blocks over its "
                    f"bound of {self.max_blocks}")
            total = sum(e.nbytes for e in self._entries.values())
            if total != self._nbytes:
                probs.append(
                    f"host pool byte accounting drifted: tracked "
                    f"{self._nbytes}, actual {total}")
            for key, ent in self._entries.items():
                shape = tuple(getattr(ent.k, "shape", ()))
                if shape != self.block_shape:
                    probs.append(
                        f"host entry {key.hex()[:12]} has slice shape "
                        f"{shape}, pool geometry {self.block_shape}")
        return probs
