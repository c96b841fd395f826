"""Inference engine: the serving paths of ``deepspeed_tpu/inference/engine.py``
in PyTorch.

``InferenceEngine.generate_batch`` serves many prompts through the
:class:`ContinuousBatchingScheduler` over a paged KV cache. Each scheduler
action runs one forward of the model: a ``prefill`` runs
``forward_paged_prefill`` (flash-attention kernel), a ``prefill_chunk`` (the
tail after a prefix-cache hit) runs ``forward_paged_prefill_chunk`` after a
copy-on-write of a shared block if needed, a ``decode`` runs
``forward_paged_decode`` over every running request at once (paged
decode-attention kernel, once per layer).

``InferenceEngine.generate`` is static generation over a persistent dense KV
workspace: one right-padded prefill of the whole batch, then one
``forward_cached`` per new token (dense decode-attention kernel, once per
layer); ``generate_batch`` takes it per request for ``serving.paged="off"``
and for models that cannot page. ``forward`` is the full-sequence forward.

Where the JAX engine jit-compiles each step with donated buffers (and runs
the whole decode loop on the device), the port runs eagerly, updates the
pools and the workspace in place, and loops over tokens on the host.
Settings outside the port's slices raise ``NotImplementedError`` naming
the ROADMAP item that will bring them.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.inference.block_allocator import DUMMY_BLOCK, BlockAllocator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig, DtypeEnum
from deepspeed_tpu_torch.inference.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.models.transformer import copy_paged_block
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.not_ported import not_ported


class InferenceEngine:

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params=None, device=None):
        self.module = model
        self._config = config or DeepSpeedInferenceConfig()
        self._refuse_outside_slice(model)
        self.device = resolve_device(device)
        self.dtype = DtypeEnum.from_any(self._config.dtype).torch
        cfg = getattr(model, "config", None)
        if (self.device.type == "cuda" and self.dtype == torch.float32
                and getattr(cfg, "attention_backend", "auto") != "xla"):
            raise ValueError("the CUDA attention kernels take fp16/bf16: serve with "
                             "dtype='bf16' (or 'fp16') on the GPU")
        if params is None:
            if not hasattr(model, "init_params"):
                raise ValueError("InferenceEngine needs params (or a model with init_params)")
            # seeded random init on the device (the JAX engine's key(0))
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init_params(gen, device=self.device, dtype=self.dtype)
        self.params = params.map(
            lambda t: t.to(device=self.device,
                           dtype=self.dtype if t.is_floating_point() else t.dtype))
        self._workspace = None       # (B, Smax, cache): static generate's KV workspace
        self._paged_workspace = None
        self._paged_alloc = None     # persistent prefix-cache allocator
        self._serve_rid_base = 0     # rids unique across generate_batch calls
        self._active_session = None  # at most ONE serving session owns the pools
        self._last_serve_stats = {}
        self._last_serve_actions = {}
        log_dist(f"InferenceEngine ready: dtype={self.dtype}, device={self.device}",
                 ranks=[0])

    def _refuse_outside_slice(self, model) -> None:
        c = self._config
        srv = c.serving
        if DtypeEnum.from_any(c.dtype) == DtypeEnum.int8:
            not_ported("int8 weight-only quantization (dtype='int8')", "queue 1: int8 inference")
        if int(c.tensor_parallel.tp_size) > 1 or int(srv.tp) > 1 or int(c.mp_size) > 1:
            not_ported("tensor-parallel serving", "queue 1: sharded serving")
        if int(srv.replicas.dp) > 1:
            not_ported("serving replicas (serving.replicas.dp > 1)", "queue 1: sharded serving")
        if int(c.moe.ep_size) > 1 or int(c.ep_size) > 1 or hasattr(model, "moe"):
            not_ported("MoE inference", "queue 1: MoE")
        off = dict(c.zero or {}).get("offload_param", {})
        if str(off.get("device", "none")).lower() in ("cpu", "nvme"):
            not_ported("ZeRO-Inference weight streaming", "queue 1: ZeRO-Inference")
        if c.telemetry_enabled():
            not_ported("serving telemetry", "queue 1: telemetry and control plane")
        if c.checkpoint is not None or isinstance(model, str):
            not_ported("checkpoint loading", "queue 1: checkpoint ingestion")
        if srv.kv_host.enabled:
            not_ported("the tiered KV cache (serving.kv_host)", "queue 1: tiered KV cache")
        if str(srv.speculative.mode) == "ngram":
            not_ported("speculative decoding (serving.speculative.mode='ngram')",
                       "queue 1: speculative decoding")

    # ------------------------------------------------------------------ #
    # helpers shared with the JAX engine

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Pad prompt lengths up to multiples of 128, clamped to the model's
        max (the JAX engine's compile buckets, kept so slots and actions
        match it)."""
        return min(-(-max(n, 1) // 128) * 128, cap)

    @staticmethod
    def _flat_slots(table, start, n_valid, width, bs):
        """Flat pool slot per position ``start + t`` for t in [0, width):
        the first ``n_valid`` write through the request's block table,
        bucket pads go to the dummy block."""
        t = np.arange(width)
        p_t = start + t
        slot = table[np.minimum(p_t // bs, table.size - 1)] * bs + p_t % bs
        return np.where(t < n_valid, slot, DUMMY_BLOCK * bs + p_t % bs)

    @staticmethod
    def _sample(logits, temperature, top_k, generator):
        """Next tokens ``[B]`` on the logits' device from logits ``[B, V]``:
        greedy argmax, or temperature / top-k sampling in fp32 from
        ``generator`` (a generator on that device), the counterpart of the
        JAX engine's ``_sample_jit``."""
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        logits = logits.float() / max(temperature, 1e-6)
        if top_k > 0:
            kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, float("-inf"), logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def _reject_encoders(self, what: str) -> None:
        """Generation needs a causal LM."""
        if getattr(getattr(self.module, "config", None), "causal", True) is False:
            raise ValueError(f"{type(self.module).__name__} is an encoder; {what} requires a "
                             "causal LM; use engine.forward for hidden states / MLM logits")

    def _paged_supported(self) -> bool:
        return (hasattr(self.module, "forward_paged_decode")
                and hasattr(self.module, "forward_paged_prefill")
                and hasattr(self.module, "init_paged_cache")
                and hasattr(self.module, "config"))

    def _paged_pools(self, num_blocks: int, block_size: int):
        """Persistent paged-pool workspace, reused across serves with the
        same geometry. Returns ``(pools, reused)``."""
        pw = self._paged_workspace
        if pw is not None and pw[0] == num_blocks and pw[1] == block_size:
            return pw[2], True
        self._paged_workspace = None     # free the old pools before allocating
        pools = self.module.init_paged_cache(num_blocks, block_size, dtype=self.dtype,
                                             device=self.device)
        self._paged_workspace = (num_blocks, block_size, pools)
        return pools, False

    def _paged_allocator(self, num_blocks: int, block_size: int, caching: bool,
                         pools_reused: bool):
        """Block allocator for one serve call; with prefix caching it
        persists across calls while the pool workspace does and every
        request of the previous call retired cleanly."""
        if not caching:
            self._paged_alloc = None
            return BlockAllocator(num_blocks, block_size)
        pa = self._paged_alloc
        if (pools_reused and pa is not None and pa.num_blocks == num_blocks
                and pa.block_size == block_size and not pa.leak_report()):
            return pa
        alloc = BlockAllocator(num_blocks, block_size, prefix_cache=True)
        self._paged_alloc = alloc
        return alloc

    # ------------------------------------------------------------------ #
    # full-sequence forward and static generation

    def _ids(self, input_ids):
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long)
        return (ids[None, :] if ids.ndim == 1 else ids).to(self.device)

    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None):
        """Full-sequence forward: tokens ``[B, S]`` (or ``[S]``) -> logits
        ``[B, S, vocab]`` on the engine's device."""
        mask = None
        if attention_mask is not None:
            mask = torch.as_tensor(np.asarray(attention_mask)).to(self.device)
            mask = mask[None, :] if mask.ndim == 1 else mask
        return self.module.forward(self.params, self._ids(input_ids), mask)

    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 eos_token_id: Optional[int] = None):
        """Autoregressive generation (greedy, or sampled from a generator
        seeded with ``seed``) for a batch of equal-length prompts ``[B, S]``
        (or one ``[S]``). Returns int32 numpy ``[B, S + n]``: the prompts and
        ``n <= max_new_tokens`` new tokens (fewer when every row has emitted
        ``eos_token_id``; a row that has keeps emitting it). Models with a
        KV-cache forward run over the persistent dense workspace; others
        recompute the full prefix per token."""
        input_ids = self._ids(input_ids)
        self._reject_encoders("generate()")
        max_new = max_new_tokens if max_new_tokens is not None else self._config.max_out_tokens
        max_len = input_ids.shape[1] + max_new
        cfg = getattr(self.module, "config", None)
        if cfg is not None and hasattr(cfg, "max_seq") and max_len > cfg.max_seq:
            raise ValueError(f"Input+generated length {max_len} exceeds model max_seq "
                             f"{cfg.max_seq}; reduce max_new_tokens (reference "
                             "max_out_tokens check)")
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        if hasattr(self.module, "forward_cached") and hasattr(self.module, "init_cache"):
            out = self._generate_cached(input_ids, max_new, temperature, top_k, gen,
                                        eos_token_id)
        else:
            out = self._generate_full(input_ids, max_new, temperature, top_k, gen, eos_token_id)
        return out.cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def _generate_full(self, tokens, max_new, temperature, top_k, gen, eos_token_id):
        """Models without a cached forward: the full prefix per new token."""
        for _ in range(max_new):
            nxt = self._sample(self.forward(tokens)[:, -1, :], temperature, top_k, gen)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
            if eos_token_id is not None and bool((nxt == eos_token_id).all()):
                break
        return tokens

    def _kv_workspace(self, B: int, need_len: int):
        """The persistent KV workspace: allocated once, reused across calls,
        replaced by a larger one when a call needs more length or batch. A
        call with a smaller batch runs on a copy of the first ``B`` rows and
        leaves the workspace as it is; reuse is safe because causality hides
        the slots past the current position. Returns ``(cache, Smax)``."""
        ws = self._workspace
        if ws is not None and ws[0] >= B and ws[1] >= need_len:
            if ws[0] == B:
                return ws[2], ws[1]
            return {k: c[:, :B].clone() for k, c in ws[2].items()}, ws[1]
        cfg = self.module.config
        Smax = min(cfg.max_seq, max(need_len, int(self._config.max_out_tokens)))
        self._workspace = None           # free the old workspace before allocating
        cache = self.module.init_cache(B, Smax, dtype=self.dtype, device=self.device)
        self._workspace = (B, Smax, cache)
        return cache, Smax

    @torch.no_grad()
    def _generate_cached(self, input_ids, max_new, temperature, top_k, gen, eos_token_id):
        """Prefill the right-padded 128-bucket at pos 0, take the first token
        from the logits at the last prompt position, then one
        ``forward_cached`` per token at pos = prompt length + step. With an
        eos the loop reads one flag from the device per token to stop early
        (the JAX engine tests ``all(done)`` inside its device loop); without
        one it never syncs."""
        if max_new <= 0:
            return input_ids
        B, P = input_ids.shape
        cfg = self.module.config
        cache, Smax = self._kv_workspace(B, min(cfg.max_seq, P + max_new))
        bucket = self._bucket(P, Smax)
        toks = torch.zeros((B, bucket), dtype=torch.long, device=self.device)
        toks[:, :P] = input_ids
        logits, cache = self.module.forward_cached(self.params, toks, cache, 0)
        first = self._sample(logits[:, P - 1, :], temperature, top_k, gen)
        out_cap = min(Smax, self._bucket(max_new, Smax))
        out = torch.zeros((B, out_cap), dtype=torch.long, device=self.device)
        out[:, 0] = first
        eos = -1 if eos_token_id is None else int(eos_token_id)
        done = first == eos if eos >= 0 else None
        tok, step = first, 1
        while step < max_new and not (done is not None and bool(done.all())):
            logits, cache = self.module.forward_cached(self.params, tok[:, None], cache,
                                                       P + step - 1)
            nxt = self._sample(logits[:, -1, :], temperature, top_k, gen)
            if done is not None:
                nxt = torch.where(done, eos, nxt)    # rows already done keep emitting eos
                done = done | (nxt == eos)
            out[:, step] = nxt
            tok, step = nxt, step + 1
        return torch.cat([input_ids, out[:, :step]], dim=1)

    # ------------------------------------------------------------------ #
    # paged continuous batching

    def generate_batch(self, prompts, max_new_tokens: Optional[int] = None,
                       temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                       eos_token_id: Optional[int] = None):
        """Serve a batch of variable-length prompts with continuous batching
        over the paged KV cache. Returns a list of 1-D int32 numpy arrays
        (prompt + generated tokens, stopping at eos / max_new per request)
        in the order the prompts were given. ``config.serving`` governs the
        path: ``paged="auto"`` pages whenever the model can, ``"on"``
        requires it, ``"off"`` (and a model that cannot page under auto)
        serves each request through :meth:`generate` with seed ``seed + i``;
        prefix caching (default on) shares computed KV blocks across
        requests and across calls; ``prefill_chunk_tokens`` interleaves
        prefill chunks with decode steps."""
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        if not prompts:
            return []
        self._reject_encoders("generate_batch()")
        srv = self._config.serving
        mode = str(srv.paged)
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"serving.paged={mode!r} (expected auto|on|off)")
        supported = self._paged_supported()
        if mode == "on" and not supported:
            raise ValueError("serving.paged='on' but this engine cannot page: the "
                             "model must be a causal LM with forward_paged_decode")
        max_new = max_new_tokens if max_new_tokens is not None else self._config.max_out_tokens
        if mode == "off" or not supported:
            # static path, one request at a time; the seed offset keeps
            # sampled requests (and duplicate prompts) off one stream
            return [self.generate(p[None, :], max_new_tokens=max_new, temperature=temperature,
                                  top_k=top_k, seed=seed + i, eos_token_id=eos_token_id)[0]
                    for i, p in enumerate(prompts)]
        if max_new <= 0:
            return [p.copy() for p in prompts]

        session = self.open_serve_session(max_new=max_new, temperature=temperature,
                                          top_k=top_k, seed=seed,
                                          eos_token_id=eos_token_id)
        try:
            for p in prompts:
                session.add(p)
            while session.step():
                pass
        finally:
            session.close()
        session.end()
        failed = [r for r in session.sched.finished if r.error is not None]
        if failed:
            raise RuntimeError(
                f"{len(failed)} request(s) retired without completing (KV pool too "
                "small for the workload — raise serving.max_num_blocks): "
                + "; ".join(f"request {r.rid}: {r.error}" for r in failed))
        done = sorted(session.sched.finished, key=lambda r: r.rid)
        return [r.output for r in done]

    def open_serve_session(self, *, max_new: int, temperature: float = 0.0,
                           top_k: int = 0, seed: int = 0,
                           eos_token_id: Optional[int] = None):
        """Open one paged serving session: the scheduler, the persistent
        pool workspace and the step API (:class:`_ServeSession`). At most one
        session may be active per engine (the pools are shared state)."""
        if self._active_session is not None:
            raise RuntimeError("another serving session is active on this engine; "
                               "close it before opening a new one")
        srv = self._config.serving
        if str(srv.paged) == "off" or not self._paged_supported():
            raise ValueError("a serving session needs the paged engine")
        if max_new <= 0:
            raise ValueError("a serving session needs max_new >= 1")

        cfg = self.module.config
        bs = int(srv.block_size)
        W = int(srv.max_running)
        n_max = -(-cfg.max_seq // bs)          # block-table width
        num_blocks = int(srv.max_num_blocks) or (W * n_max + 1)

        pc_mode = str(srv.prefix_caching)
        if pc_mode not in ("auto", "on", "off"):
            raise ValueError(f"serving.prefix_caching={pc_mode!r} (expected auto|on|off)")
        chunk_tokens = int(srv.prefill_chunk_tokens)
        if chunk_tokens < 0:
            raise ValueError("serving.prefill_chunk_tokens must be >= 0")
        chunk_ok = hasattr(self.module, "forward_paged_prefill_chunk")
        if not chunk_ok and (pc_mode == "on" or chunk_tokens):
            raise ValueError("prefix caching / chunked prefill need "
                             "forward_paged_prefill_chunk on the model")
        caching = chunk_ok and pc_mode != "off"
        spec_mode = str(srv.speculative.mode)
        if spec_mode not in ("off", "ngram", "auto"):
            raise ValueError(f"serving.speculative.mode={spec_mode!r} (expected off|ngram|auto)")

        pools, pools_reused = self._paged_pools(num_blocks, bs)
        alloc = self._paged_allocator(num_blocks, bs, caching, pools_reused)
        sched = ContinuousBatchingScheduler(alloc, W, n_max, prefix_caching=caching,
                                            chunk_tokens=chunk_tokens,
                                            rid_base=self._serve_rid_base)
        session = _ServeSession(
            self, sched, pools, max_new=max_new, temperature=temperature, top_k=top_k,
            generator=torch.Generator(device=self.device).manual_seed(int(seed)),
            eos_token_id=eos_token_id, W=W, n_max=n_max, bs=bs, num_blocks=num_blocks,
            chunk_tokens=chunk_tokens)
        self._active_session = session
        return session


class _ServeSession:
    """One paged serving session: scheduler + pools behind a step API.
    Single-threaded: every method runs on the thread that owns the engine."""

    _UNSET = object()

    def __init__(self, engine, sched, pools, *, max_new, temperature, top_k, generator,
                 eos_token_id, W, n_max, bs, num_blocks, chunk_tokens):
        self.engine = engine
        self.sched = sched
        self.pools = pools
        self.max_new = int(max_new)
        self.temperature = temperature
        self.top_k = top_k
        self.generator = generator
        self.eos_token_id = eos_token_id
        self.W = W
        self.n_max = n_max
        self.bs = bs
        self.num_blocks = num_blocks
        self.chunk_tokens = chunk_tokens
        #: scheduler actions executed, by kind (plain host counters)
        self.actions = collections.Counter()
        self._closed = False

    # ---- request front-end ---- #

    def add(self, prompt, max_new=None, eos=_UNSET):
        """Enqueue one request; ``max_new``/``eos`` default to the session's."""
        if self._closed:
            raise RuntimeError("serving session is closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        mn = self.max_new if max_new is None else int(max_new)
        if mn < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mn}")
        cfg = self.engine.module.config
        if prompt.size + mn > cfg.max_seq:
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens ({mn}) exceeds "
                             f"model max_seq {cfg.max_seq}")
        return self.sched.add_request(prompt, mn,
                                      self.eos_token_id if eos is self._UNSET else eos)

    # ---- stepping ---- #

    def step(self) -> bool:
        """Execute ONE scheduler action. Returns False when nothing is
        runnable (queue and running batch both empty)."""
        if self._closed:
            raise RuntimeError("serving session is closed")
        action = self.sched.next_action()
        if action is None:
            return False
        self._exec(action)
        return True

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.engine.device)

    def _sample(self, logits):
        """Host int64 tokens ``[B]``."""
        return self.engine._sample(logits, self.temperature, self.top_k,
                                   self.generator).cpu().numpy()

    @torch.no_grad()
    def _exec(self, action) -> None:
        engine, sched, model = self.engine, self.sched, self.engine.module
        cfg = model.config
        bs, W, n_max = self.bs, self.W, self.n_max
        kind, payload = action
        self.actions[kind] += 1
        if kind == "wait":
            return                      # retry-backoff idle tick: no device work
        if kind == "prefill":
            req = payload
            prefix = req.prefix()
            L = prefix.size
            Tb = engine._bucket(L, cfg.max_seq)
            toks = np.zeros((1, Tb), np.int64)
            toks[0, :L] = prefix
            slots = engine._flat_slots(np.asarray(req.blocks, np.int32), 0, L, Tb, bs)
            logits, self.pools = model.forward_paged_prefill(
                engine.params, self._tensor(toks, torch.long), self.pools,
                self._tensor(slots, torch.long), L - 1)
            sched.record_prefill(req, int(self._sample(logits)[0]))
        elif kind == "prefill_chunk":
            req = payload
            if req.cow_pending is not None:
                # copy-on-write split: the request restarts mid-block inside a
                # SHARED cached block — give it a private copy before it writes
                src, dst = req.cow_pending
                self.pools = copy_paged_block(self.pools, src, dst)
                req.cow_pending = None
            start = req.pos
            remaining = req.prefill_target - start
            step = min(self.chunk_tokens, remaining) if self.chunk_tokens else remaining
            Tb = engine._bucket(step, cfg.max_seq)
            prefix = req.prefix()
            toks = np.zeros((1, Tb), np.int64)
            toks[0, :step] = prefix[start:start + step]
            table = np.asarray(req.blocks, np.int32)
            slots = engine._flat_slots(table, start, step, Tb, bs)
            # gather width: next power of two of the request's own block count
            nb = min(n_max, 1 << max(int(table.size) - 1, 0).bit_length())
            bt = np.zeros((1, nb), np.int32)
            bt[0, :table.size] = table
            logits, self.pools = model.forward_paged_prefill_chunk(
                engine.params, self._tensor(toks, torch.long), self.pools,
                self._tensor(bt, torch.int32), self._tensor(slots, torch.long), start,
                step - 1)
            if start + step == req.prefill_target:
                sched.record_prefill_chunk(req, step, int(self._sample(logits)[0]))
            else:
                sched.record_prefill_chunk(req, step)
        elif kind == "decode":
            reqs = payload
            bt = np.zeros((W, n_max), np.int32)       # zeros → dummy block
            pos = np.zeros((W,), np.int32)
            toks = np.zeros((W, 1), np.int64)
            for i, r in enumerate(reqs):
                bt[i, :len(r.blocks)] = r.blocks
                pos[i] = r.pos
                toks[i, 0] = r.last_token
            logits, self.pools = model.forward_paged_decode(
                engine.params, self._tensor(toks, torch.long), self.pools,
                self._tensor(bt, torch.int32), self._tensor(pos, torch.int32))
            tok = self._sample(logits)
            for i, r in enumerate(reqs):
                sched.record_decode(r, int(tok[i]))
        else:
            not_ported(f"the {kind!r} serving action", "queue 1: speculative decoding")

    # ---- lifecycle ---- #

    def close(self) -> None:
        """Always-run bookkeeping: rid uniqueness across serves, the serve
        stats and action counts, releasing the engine's session slot."""
        if self._closed:
            return
        self._closed = True
        engine = self.engine
        engine._serve_rid_base = self.sched._next_rid
        engine._last_serve_stats = dict(self.sched.stats)
        engine._last_serve_actions = dict(self.actions)
        if engine._active_session is self:
            engine._active_session = None

    def end(self) -> None:
        """Success-path epilogue: hand the pools back to the engine's
        persistent workspace so the next serve reuses them (and, with prefix
        caching, re-hits this serve's blocks)."""
        self.engine._paged_workspace = (self.num_blocks, self.bs, self.pools)
