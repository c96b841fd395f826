"""KV block allocator for the paged serving path (a copy of
``deepspeed_tpu/inference/block_allocator.py``: host-only numpy logic,
kept identical so both packages place blocks identically).

The host-side twin of the device pools built by
``models/transformer.py::init_paged_kv_cache``: the pools are
``[n_layer, num_blocks, block_size, KV, Hd]`` arrays, and this allocator
hands out pool block ids to requests and reclaims them when requests retire
or are preempted. The analogue of vLLM's ``BlockAllocator``, including its
automatic prefix caching: blocks are REFERENCE-COUNTED, and with
``prefix_cache=True`` every FULL block is content-addressed by a rolling
hash chain ``key_j = H(key_{j-1}, tokens_j)`` so a new request whose prompt
starts with an already-cached token prefix reuses those blocks with a
ref-count bump — zero prefill compute for the shared part.

Lifecycle of a block (prefix_cache on)::

    free list --allocate--> ref>=1 --free to ref 0--+--> registered? cold LRU
        ^                      ^                    |        |        |
        |                      +----- acquire ------+--------+   reclaimed
        +------------------------- (unregistered) ----- under pressure

- ``allocate`` pops the FIFO free list first; when it runs dry it reclaims
  from the COLD list oldest-first (LRU), un-registering the reclaimed
  block's hash entry. All-or-nothing, deterministic.
- ``free`` drops one reference; at zero the block parks on the cold list
  (content intact, future prefix hits resurrect it via ``acquire``) if it
  was registered, else returns to the free list.
- Partial trailing blocks are never registered, so they are never shared;
  a request that would start writing inside a shared block must
  copy-on-write it first (the scheduler's COW split — see
  ``scheduler.py``).

Determinism: the free list is FIFO (freed blocks go to the back, allocation
pops from the front, initial order ascending), the cold list is reclaimed
strictly LRU, and hash-table registration is first-writer-wins — identical
request streams produce identical block placements (the scheduler tests
pin this).

Block 0 is RESERVED as the dummy block: prompt-bucket padding slots and
inactive decode rows scatter their junk k/v there, and nothing ever reads
it (the attention masks stop at each request's position). Routing junk to a
dedicated block keeps out-of-range scatter clipping from corrupting a live
block.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

DUMMY_BLOCK = 0

# root of every hash chain (the "parent" of a sequence's first block)
ROOT_KEY = b""


class BlockAllocator:
    """Reference-counted FIFO allocator over ``num_blocks`` pool blocks of
    ``block_size`` tokens; block 0 (``DUMMY_BLOCK``) is never handed out.
    With ``prefix_cache=True``, full blocks are content-addressed and
    freed-but-cached blocks are kept COLD for reuse until allocation
    pressure reclaims them LRU-first."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need at least one "
                             "allocatable block besides the reserved dummy")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self._free = deque(range(1, num_blocks))
        # companion set: O(1) membership for the free-list invariant checks
        self._free_set = set(self._free)
        self._ref: Dict[int, int] = {}          # block -> live references
        self._num_used = 0                       # blocks with ref > 0
        # content-addressed cache state (only populated when prefix_cache)
        self._cold: "OrderedDict[int, bytes]" = OrderedDict()  # LRU: old first
        self._table: Dict[bytes, int] = {}       # chain key -> block id
        self._key_of: Dict[int, bytes] = {}      # registered block -> its key
        # tiered KV cache (inference/kv_host_pool.py): when a host pool is
        # attached, reclaiming a cold block DEMOTES it — the spill hook
        # (engine-bound: it owns the pools and the D2H gather program)
        # copies the block's content host-side under its chain key before
        # the block id is reused — and the tiered match walk below finds
        # demoted chains for re-materialization on admission
        self.host_pool = None
        self._spill_fn = None       # (block, key) -> bool; session-scoped

    # ------------------------------------------------------------------ #
    # capacity accounting

    @property
    def num_free(self) -> int:
        """Blocks allocatable right now (free list + reclaimable cold)."""
        return self.num_blocks - 1 - self._num_used

    @property
    def num_free_list(self) -> int:
        """Blocks on the plain free list ONLY — allocating this many never
        reclaims a cold cached block (no prefix-cache registration is
        destroyed). Opportunistic consumers (the speculative verify window)
        bound themselves here so best-effort capacity never cannibalizes
        the cache that mandatory allocation would have hit."""
        return len(self._free)

    @property
    def num_used(self) -> int:
        """Blocks referenced by at least one live request."""
        return self._num_used

    @property
    def num_cold(self) -> int:
        """Freed-but-cached blocks (content retained for prefix hits)."""
        return len(self._cold)

    @property
    def capacity(self) -> int:
        """Total allocatable blocks (everything but the reserved dummy)."""
        return self.num_blocks - 1

    def blocks_for_tokens(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cached tokens."""
        return -(-max(num_tokens, 0) // self.block_size)

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def leak_report(self) -> Dict[int, int]:
        """Blocks still referenced — empty once every request retired
        (the test-suite teardown assertion; cold blocks are NOT leaks)."""
        return {b: r for b, r in self._ref.items() if r > 0}

    # ------------------------------------------------------------------ #
    # allocate / free / acquire

    def allocate(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks (ref-count 1 each), or None (all-or-nothing)
        when fewer than ``n`` are available. The FIFO free list is drained
        first; under pressure the cold list is reclaimed LRU-first, each
        reclaimed block losing its cache registration."""
        if n > len(self._free) + len(self._cold):
            return None
        got: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.popleft()
                self._free_set.discard(b)
            else:
                b, key = self._cold.popitem(last=False)   # LRU eviction
                if self._spill_fn is not None:
                    # demote instead of destroy: the hook D2H-copies the
                    # block's content into the host pool under its chain
                    # key (dispatched BEFORE the new owner's writes, so
                    # stream order reads the pre-overwrite content); hook
                    # failures degrade to today's destroy-on-reclaim and
                    # never surface here
                    self._spill_fn(b, key)
                del self._table[key]
                del self._key_of[b]
            self._ref[b] = 1
            self._num_used += 1
            got.append(b)
        return got

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; zero-ref registered blocks park on
        the cold list (MRU end), unregistered ones rejoin the free list."""
        for b in blocks:
            if b == DUMMY_BLOCK:
                raise ValueError("attempted to free the reserved dummy block")
            if not (0 < b < self.num_blocks):
                raise ValueError(f"block id {b} out of range")
            r = self._ref.get(b, 0)
            if r <= 0:
                raise ValueError(f"double free of block {b}")
            r -= 1
            self._ref[b] = r
            if r == 0:
                self._num_used -= 1
                key = self._key_of.get(b)
                if key is not None:
                    self._cold[b] = key           # most-recently-used end
                else:
                    self._free.append(b)
                    self._free_set.add(b)

    def acquire(self, blocks: List[int]) -> None:
        """Bump the reference count of already-placed blocks (a prefix-cache
        hit). Cold blocks are resurrected (removed from the LRU list)."""
        for b in blocks:
            r = self._ref.get(b, 0)
            if r == 0:
                if b not in self._cold:
                    raise ValueError(
                        f"acquire of block {b} which is neither live nor "
                        "cold (stale prefix-cache hit?)")
                del self._cold[b]
                self._num_used += 1
            self._ref[b] = r + 1

    # ------------------------------------------------------------------ #
    # content-addressed prefix cache

    @staticmethod
    def chain_key(parent: bytes, tokens) -> bytes:
        """Rolling hash of (parent-block key, this block's tokens): the
        content address of a full block. blake2b-128 over exact bytes —
        deterministic across processes, collision odds negligible."""
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
        return h.digest()

    def match_prefix(self, tokens) -> Tuple[List[int], List[bytes]]:
        """Longest chain of cached FULL blocks matching the front of
        ``tokens``. Read-only (no ref-count changes — callers ``acquire``
        the hit only once the rest of the admission succeeds). Returns
        ([block ids], [chain keys])."""
        if not self.prefix_cache:
            return [], []
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        blocks: List[int] = []
        keys: List[bytes] = []
        parent = ROOT_KEY
        for j in range(tokens.size // bs):
            key = self.chain_key(parent, tokens[j * bs:(j + 1) * bs])
            b = self._table.get(key)
            if b is None:
                break
            blocks.append(b)
            keys.append(key)
            parent = key
        return blocks, keys

    def register(self, block: int, key: bytes) -> bool:
        """Publish a FULL block under its chain key so future admissions can
        hit it. First-writer-wins: a key already registered (two requests
        racing the same prefix) keeps the existing mapping and this block
        stays private. Returns True when the registration took."""
        if not self.prefix_cache or block == DUMMY_BLOCK:
            return False
        if key in self._table or block in self._key_of:
            return False
        self._table[key] = block
        self._key_of[block] = key
        if self.host_pool is not None:
            # a device registration supersedes any host copy of the same
            # content (a recompute landed the identical bytes on device) —
            # a chain key lives in at most one tier. Safe against the
            # speculative optimistic-register-then-rollback flow: under
            # greedy-only speculation a rolled-back candidate chain can
            # only collide with a demoted COMMITTED key if the model
            # would re-commit those exact tokens — in which case verify
            # accepts them and no rollback happens (revisit if sampled
            # speculation ever registers candidate-keyed blocks).
            self.host_pool.discard(key)
        return True

    # ------------------------------------------------------------------ #
    # tiered KV cache (host-RAM spill pool)

    def attach_host_pool(self, host_pool) -> None:
        """Attach (or detach with None) the host-memory tier. Attaching
        makes the tiered match walk probe demoted chains; demotion itself
        additionally needs a spill hook (:meth:`set_spill`)."""
        self.host_pool = host_pool if self.prefix_cache else None

    def set_spill(self, spill_fn) -> None:
        """Install the session-scoped demotion hook ``(block, key) ->
        bool``. The hook is engine-bound (it reads the live pools and runs
        the jitted per-block gather), must never raise, and is cleared at
        session close — a stale hook would capture freed pool buffers."""
        self._spill_fn = spill_fn if self.host_pool is not None else None

    def match_prefix_tiered(self, tokens) -> Tuple[List[Tuple], List[bytes]]:
        """Longest chain of cached FULL blocks matching the front of
        ``tokens`` across BOTH tiers: each chain position resolves to
        ``("dev", block_id)`` (device-registered) or ``("host", key)``
        (demoted to the host pool), stopping at the first key in neither.
        Read-only — no ref counts, no host LRU reordering. With no host
        pool attached this degenerates to :meth:`match_prefix`."""
        if not self.prefix_cache:
            return [], []
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        entries: List[Tuple] = []
        keys: List[bytes] = []
        parent = ROOT_KEY
        for j in range(tokens.size // bs):
            key = self.chain_key(parent, tokens[j * bs:(j + 1) * bs])
            b = self._table.get(key)
            if b is not None:
                entries.append(("dev", b))
            elif self.host_pool is not None and self.host_pool.contains(key):
                entries.append(("host", key))
            else:
                break
            keys.append(key)
            parent = key
        return entries, keys

    def demote_chain(self, tokens) -> int:
        """Force-demote the COLD cached FULL blocks of ``tokens``'s hash
        chain into the host tier — the prefill→decode KV handoff's push
        half (``inference/router.py``): after a prefill replica commits a
        prompt's blocks, demoting them publishes the content in the
        SHARED host pool, where a decode replica's tiered admission walk
        finds it and re-materializes H2D (the PR-12 fetch path — the host
        tier is the transport, no new wire format).

        Per matched chain position: a block still referenced by a live
        request is left on device untouched (it is serving traffic here —
        and unregistering it would violate the one-tier-per-key
        invariant), a key already host-resident just extends the walk,
        and a cold block is spilled via the session hook then freed +
        unregistered (device copy gone, host copy authoritative). A spill
        hook failure keeps the device copy — demotion is best-effort
        cache movement, never data loss. Returns the number of blocks
        demoted."""
        if (not self.prefix_cache or self.host_pool is None
                or self._spill_fn is None):
            return 0
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        parent = ROOT_KEY
        demoted = 0
        for j in range(tokens.size // bs):
            key = self.chain_key(parent, tokens[j * bs:(j + 1) * bs])
            b = self._table.get(key)
            if b is None:
                if self.host_pool.contains(key):
                    parent = key
                    continue          # already demoted: keep walking
                break                 # key in neither tier: chain ends
            parent = key
            if b not in self._cold:
                continue              # hot: a live request holds it
            if not self._spill_fn(b, key):
                continue              # spill failed: keep the device copy
            del self._cold[b]
            del self._table[key]
            del self._key_of[b]
            self._free.append(b)
            self._free_set.add(b)
            demoted += 1
        return demoted

    def host_consistency(self) -> List[str]:
        """Tier-discipline violations (empty = consistent): the host
        pool's own invariants plus the cross-tier rule that a chain key
        lives in at most one tier. The conftest ``_no_kv_block_leaks``
        fixture asserts this on every drained scheduler — demoted blocks
        are cache copies, never leaks."""
        if self.host_pool is None:
            return []
        probs = self.host_pool.consistency_report()
        for key in self.host_pool.keys():
            if key in self._table:
                probs.append(
                    f"chain key {key.hex()[:12]} registered on device "
                    f"(block {self._table[key]}) AND resident in the host "
                    "pool — a key must live in exactly one tier")
        return probs

    def unregister_if_owner(self, block: int, key: bytes) -> bool:
        """Withdraw ``block``'s registration under ``key`` — the rollback
        half of speculative decoding: a block that filled DURING a verify
        window was registered with candidate tokens in its hash chain, and
        when those candidates are rejected its tail slots will be
        overwritten by the real continuation, so the key would describe
        content that no longer exists. First-writer-wins is preserved: when
        ``key`` maps to a DIFFERENT block (another request registered the
        same content first, so this block's ``register`` never took — that
        owner's content IS committed) the mapping is left untouched.
        Returns True when the registration was removed.

        Callers normally roll back while still holding a reference to the
        block; a zero-ref block parked COLD under this key loses its only
        address, so it is moved back to the free list (nothing can ever
        resurrect it)."""
        if not self.prefix_cache:
            return False
        if self._table.get(key) != block or self._key_of.get(block) != key:
            return False
        del self._table[key]
        del self._key_of[block]
        if block in self._cold:
            del self._cold[block]
            self._free.append(block)
            self._free_set.add(block)
        return True
