"""Inference engine: the serving paths of ``deepspeed_tpu/inference/engine.py``
in PyTorch.

``InferenceEngine.generate_batch`` serves many prompts through the
:class:`ContinuousBatchingScheduler` over a paged KV cache. Each scheduler
action runs one forward of the model: a ``prefill`` runs
``forward_paged_prefill`` (flash-attention kernel), a ``prefill_chunk`` (the
tail after a prefix-cache hit) runs ``forward_paged_prefill_chunk`` after a
copy-on-write of a shared block if needed, a ``decode`` runs
``forward_paged_decode`` over every running request at once (paged
decode-attention kernel, once per layer), and with
``serving.speculative.mode="ngram"`` a ``verify`` runs
``forward_paged_verify`` over each request's window of n-gram candidates
(the paged kernel once per window position and layer) and keeps the
longest prefix greedy decode agrees with.

``InferenceEngine.generate`` is static generation over a persistent dense KV
workspace: one right-padded prefill of the whole batch, then one
``forward_cached`` per new token (dense decode-attention kernel, once per
layer); ``generate_batch`` takes it per request for ``serving.paged="off"``
and for models that cannot page. ``forward`` is the full-sequence forward.

Where the JAX engine jit-compiles each step with donated buffers (and runs
the whole decode loop on the device), the port runs eagerly, updates the
pools and the workspace in place, and loops over tokens on the host.

With ``telemetry`` on, the scheduler feeds the serving series of the
metrics registry (TTFT, TPOT, queue and KV gauges, step counters) and, with
``telemetry.events``, the flight recorder gets the JAX engine's event
stream: ``serve.begin`` / ``serve.end`` around ``generate_batch`` and the
timed ``req.prefill``, ``req.prefill_chunk``, ``req.cow_copy``,
``decode.tick`` and ``req.spec_verify`` spans, each with its
``serving/phase_ms`` observation. A span that ends with a token read is
clocked from before its forward is dispatched until the token is on the
host, so it times the device work and not the launch queue. A span with
no token read (a copy-on-write copy, a non-final prefill chunk) is timed
on the card by a pair of CUDA events and emitted at the session's next
token read, which the loop makes anyway: telemetry adds no sync.

``open_serve_session`` is the step API both front-ends share:
``generate_batch`` adds its batch and drains, the always-on
``AsyncServingEngine`` (``inference/serve.py``) feeds arrivals in as they
come. The session streams each burst to ``on_tokens`` and each retired
request to ``on_finish``, and contains step faults for the loop: a fault
before a forward re-queues the action's requests through recompute
(quarantine after ``serving.fault.max_request_retries``), a fault between a
forward's start and the adoption of the pools it wrote is engine-fatal and
``restart_engine`` rebuilds the pools and re-admits every request
(``utils/fault_injection.step_fault`` plants either).

Settings outside the port's slices raise ``NotImplementedError`` naming
the ROADMAP item that will bring them.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.inference.block_allocator import DUMMY_BLOCK, BlockAllocator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig, DtypeEnum
from deepspeed_tpu_torch.inference.scheduler import ContinuousBatchingScheduler, ServingTelemetry
from deepspeed_tpu_torch.inference.spec import NgramProposer
from deepspeed_tpu_torch.models.transformer import copy_paged_block
from deepspeed_tpu_torch.utils.fault_injection import step_fault
from deepspeed_tpu_torch.utils.logging import log_dist, logger, warn_once
from deepspeed_tpu_torch.utils.not_ported import not_ported


class InferenceEngine:

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params=None, device=None):
        self._config = config or DeepSpeedInferenceConfig()
        self._refuse_outside_slice(model)
        self.device = resolve_device(device)
        self._acc = get_accelerator(self.device.type)
        self.dtype = DtypeEnum.from_any(self._config.dtype).torch
        cfg = getattr(model, "config", None)
        if (self.device.type == "cuda" and self.dtype == torch.float32
                and getattr(cfg, "attention_backend", "auto") != "xla"):
            raise ValueError("the CUDA attention kernels take fp16/bf16: serve with "
                             "dtype='bf16' (or 'fp16') on the GPU")
        if params is None:
            model, params = self._load_checkpoint(model)
        self.module = model
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

        # ---- telemetry (serving stats + build watchdog) ----
        tcfg = self._config.telemetry
        self._telemetry = tcfg if tcfg.enabled else None
        self._serving_tel = None
        # flight recorder: None when off, so every emit site gates at one
        # None check and allocates nothing
        self._events = None
        if self._telemetry is not None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            from deepspeed_tpu_torch.monitor.trace import get_compile_watchdog
            reg = get_registry()
            reg.set_enabled(True)
            self._tel_reg = reg
            self._tel_watchdog = get_compile_watchdog()
            self._serving_tel = ServingTelemetry(reg)
            if tcfg.events.enabled:
                from deepspeed_tpu_torch.monitor.events import TaggedRecorder, get_flight_recorder
                # one global ring; the wrapper stamps replica= on every event
                self._events = TaggedRecorder(get_flight_recorder().enable(
                    capacity=tcfg.events.capacity))
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
        if srv.kv_host.enabled:
            not_ported("the tiered KV cache (serving.kv_host)", "queue 1: tiered KV cache")

    def _load_checkpoint(self, model):
        """The JAX engine's checkpoint branch: an HF checkpoint (a directory
        or weights file, as ``config.checkpoint`` or the model given as a
        path) loads through the per-architecture policies, streamed onto the
        engine's device in its dtype; a ds_inference meta json (a path
        ending in .json, or a dict) loads the Megatron per-rank files
        against ``model.config``. Returns ``(model, params)``, params None
        without a checkpoint."""
        ckpt = self._config.checkpoint
        if isinstance(model, str) and ckpt is None:
            ckpt, model = model, None
        if isinstance(ckpt, str) and not ckpt.endswith(".json"):
            from deepspeed_tpu_torch.module_inject import load_hf_checkpoint
            loaded, params = load_hf_checkpoint(ckpt, dtype=self.dtype, device=self.device)
            n_params = sum(p.numel() for p in params.parameters())
            log_dist(f"InferenceEngine: loaded HF checkpoint {ckpt} "
                     f"({n_params / 1e6:.1f}M params)", ranks=[0])
            return (loaded if model is None else model), params
        if isinstance(ckpt, (dict, str)):
            from deepspeed_tpu_torch.module_inject.megatron import load_megatron_checkpoint
            if model is None or not hasattr(model, "config"):
                raise ValueError("Megatron meta-json checkpoints need the model "
                                 "(with .config) passed to init_inference")
            params = load_megatron_checkpoint(ckpt, model.config, dtype=self.dtype,
                                              device=self.device)
            log_dist("InferenceEngine: loaded Megatron ds_inference checkpoint "
                     f"({len(list(params.parameters()))} tensors)", ranks=[0])
            return model, params
        return model, None

    # ------------------------------------------------------------------ #
    # telemetry

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    def telemetry_snapshot(self) -> Dict:
        """Whole-process registry snapshot plus the build watchdog's
        summary under ``"compile"``. Empty dict when telemetry is off."""
        if self._telemetry is None:
            return {}
        from deepspeed_tpu_torch.monitor.health import sample_memory_gauges
        sample_memory_gauges(self._tel_reg, self._acc)
        snap = self._tel_reg.snapshot()
        snap["compile"] = self._tel_watchdog.summary()
        return snap

    def export_serving_trace(self, path: str) -> str:
        """Render the flight recorder's serving events as chrome-trace JSON
        (Perfetto / chrome://tracing): one track per request with its
        admission-to-retire span and prefill / decode / COW child slices,
        plus queue-depth and KV-block counter tracks. Requires
        ``telemetry.events``; ``tools/validate_trace.py`` checks the file."""
        if self._events is None:
            raise ValueError(
                "serving trace export needs the flight recorder: set "
                "telemetry.events (e.g. telemetry={'events': True}) on "
                "init_inference")
        from deepspeed_tpu_torch.monitor.events import export_serving_trace
        return export_serving_trace(self._events.snapshot(), path)

    def set_replica(self, name: str) -> None:
        """Name this engine's replica: the tag lands on every flight-recorder
        event it emits and on its ``serving/phase_ms`` /
        ``serving/wasted_tokens`` label sets (default ``r0``)."""
        name = str(name)
        if self._events is not None:
            self._events.replica = name
        if self._serving_tel is not None:
            self._serving_tel.replica = name

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
            if str(srv.speculative.mode) == "ngram":
                warn_once("serving.speculative is ignored on the static (non-paged) serving "
                          "path: speculation needs the paged engine (serving.paged)")
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
        ev = self._events
        t_serve0 = time.monotonic_ns() if ev is not None else 0
        if ev is not None:
            ev.emit("serve.begin", t_ns=t_serve0, requests=len(prompts))
        try:
            for p in prompts:
                session.add(p)
            while session.step():
                pass
        finally:
            session.close()
        if ev is not None:
            ev.emit("serve.end", t_ns=t_serve0, dur_ns=time.monotonic_ns() - t_serve0,
                    requests=len(prompts))
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
                           eos_token_id: Optional[int] = None, policy=None,
                           on_tokens=None, on_finish=None,
                           retain_finished: bool = True):
        """Open one paged serving session: the scheduler, the persistent
        pool workspace and the step API (:class:`_ServeSession`; JAX
        ``inference/engine.py:1289``). Both entry points run through it:
        ``generate_batch`` adds its whole batch and drains, the always-on
        ``AsyncServingEngine`` (``inference/serve.py``) feeds arrivals in as
        they come. At most one session may be active per engine (the pools
        are shared state).

        ``policy`` plugs a scheduling policy (``inference/policy.py``) into
        the scheduler; ``on_tokens(req, tokens)`` streams each emitted burst
        and ``on_finish(req)`` fires once per retired request, both on the
        serving thread. ``retain_finished=False`` drops retired requests
        from ``sched.finished`` once ``on_finish`` has seen them."""
        if self._active_session is not None:
            raise RuntimeError(
                "another serving session is active on this engine (an "
                "AsyncServingEngine loop, or a generate_batch in flight); "
                "drain/shutdown it before opening a new one")
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
        spec = srv.speculative
        spec_mode = str(spec.mode)
        if spec_mode not in ("off", "ngram", "auto"):
            raise ValueError(f"serving.speculative.mode={spec_mode!r} (expected off|ngram|auto)")
        spec_on = spec_mode == "ngram"          # "auto" is reserved: off
        if spec_on and not hasattr(self.module, "forward_paged_verify"):
            raise ValueError("serving.speculative.mode='ngram' but the model has no "
                             "forward_paged_verify (the fused verify step); serve a causal "
                             "LM of the model zoo or set mode='off'")
        if spec_on and temperature > 0.0:
            # acceptance is exact for greedy argmax only
            warn_once("serving.speculative is greedy-only: temperature > 0 disables "
                      "speculation for this call")
            spec_on = False
        spec_k = int(spec.k)
        if spec_on and spec_k < 1:
            raise ValueError("serving.speculative.k must be >= 1")
        proposer, spec_wb = None, 0
        if spec_on:
            proposer = NgramProposer(min_match=int(spec.min_match),
                                     max_match=int(spec.max_match))
            # the JAX engine's window bucket: the next power of two above k
            spec_wb = 1 << spec_k.bit_length()

        pools, pools_reused = self._paged_pools(num_blocks, bs)
        alloc = self._paged_allocator(num_blocks, bs, caching, pools_reused)
        if self._serving_tel is not None:
            self._serving_tel.tp.set(1.0)      # one device: no head-sharded pools
        sched = ContinuousBatchingScheduler(alloc, W, n_max,
                                            telemetry=self._serving_tel,
                                            prefix_caching=caching,
                                            chunk_tokens=chunk_tokens,
                                            events=self._events,
                                            rid_base=self._serve_rid_base,
                                            spec_k=spec_k if spec_on else 0,
                                            spec_proposer=proposer, policy=policy)
        session = _ServeSession(
            self, sched, pools, max_new=max_new, temperature=temperature, top_k=top_k,
            generator=torch.Generator(device=self.device).manual_seed(int(seed)),
            eos_token_id=eos_token_id, W=W, n_max=n_max, bs=bs, num_blocks=num_blocks,
            chunk_tokens=chunk_tokens, spec_wb=spec_wb, on_tokens=on_tokens,
            on_finish=on_finish, retain_finished=retain_finished)
        self._active_session = session
        return session


class _ServeSession:
    """One paged serving session: scheduler + pools behind a step API (JAX
    ``inference/engine.py:1438``). ``generate_batch`` (closed loop) and
    ``AsyncServingEngine`` (open loop) both execute scheduler actions
    through it. Single-threaded: every method runs on the thread that owns
    the engine."""

    _UNSET = object()

    def __init__(self, engine, sched, pools, *, max_new, temperature, top_k, generator,
                 eos_token_id, W, n_max, bs, num_blocks, chunk_tokens, spec_wb,
                 on_tokens=None, on_finish=None, retain_finished=True):
        self.engine = engine
        self.sched = sched
        self.pools = pools
        # fault containment (serving.fault): the action a fault is
        # attributed to, the finer dispatch site for step_faults{kind=}
        # (a prefill chunk may run a cow copy first), and the retry bounds
        self.last_action = None
        self.fault_site = None
        fault = engine._config.serving.fault
        self.fault_max_retries = int(fault.max_request_retries)
        self.fault_backoff_steps = int(fault.retry_backoff_steps)
        # False from the start of a pool-writing forward until the session
        # adopts its pools: a fault in between leaves them half-written,
        # which is engine-fatal (the JAX session's donated-buffer test)
        self._pools_valid = True
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
        self.spec_wb = spec_wb          # verify window width (0: speculation off)
        self.on_tokens = on_tokens
        self.on_finish = on_finish
        # the always-on loop consumes results through on_finish and must
        # not keep every retired Request forever
        self.retain_finished = retain_finished
        self._finished_seen = 0
        #: scheduler actions executed, by kind (plain host counters)
        self.actions = collections.Counter()
        self._closed = False
        # flight recorder (None when off) and the spans with no token read
        # of their own, waiting for the next one (CUDA only)
        self.ev = engine._events
        self._pending_spans = []

    # ---- request front-end ---- #

    def add(self, prompt, max_new=None, eos=_UNSET, priority: int = 0,
            ttft_budget=None, t_submit=None, deadline_ms=None,
            deadline_steps=None, trace=None, parent=None):
        """Enqueue one request, at any time (JAX ``engine.py:1502``);
        ``max_new``/``eos`` default to the session's."""
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
        return self.sched.add_request(
            prompt, mn, self.eos_token_id if eos is self._UNSET else eos,
            priority=priority, ttft_budget=ttft_budget, t_submit=t_submit,
            deadline_ms=deadline_ms, deadline_steps=deadline_steps,
            trace=trace, parent=parent)

    def cancel(self, req) -> bool:
        """Cancel between steps; fires ``on_finish`` for the retired request
        (JAX ``engine.py:1526``)."""
        ok = self.sched.cancel_request(req)
        self._flush_finished()
        return ok

    # ---- stepping ---- #

    def step(self) -> bool:
        """Execute ONE scheduler action. Returns False when nothing is
        runnable (queue and running batch both empty)."""
        if self._closed:
            raise RuntimeError("serving session is closed")
        # a fault in next_action itself must not be attributed to the
        # previous step's action or site
        self.last_action = None
        self.fault_site = None
        action = self.sched.next_action()
        if action is None:
            self._flush_finished()      # admission-time error retirements
            return False
        self.last_action = action
        self._exec(action)
        self._flush_finished()
        return True

    def _emit_tokens(self, req, tokens) -> None:
        """JAX ``engine.py:1553``."""
        if self.on_tokens is not None:
            self.on_tokens(req, [int(t) for t in tokens])

    def _flush_finished(self) -> None:
        """Hand each newly retired request to ``on_finish`` once (JAX
        ``engine.py:1557``)."""
        fin = self.sched.finished
        while self._finished_seen < len(fin):
            r = fin[self._finished_seen]
            self._finished_seen += 1
            if self.on_finish is not None:
                self.on_finish(r)
        if not self.retain_finished and self._finished_seen:
            del fin[:self._finished_seen]
            self._finished_seen = 0

    # ---- serving fault containment (serving.fault) ---- #

    def pools_alive(self) -> bool:
        """Whether the pools hold only whole steps (JAX ``engine.py:1570``).
        The port writes the pools in place instead of donating them, so the
        test is the session's own flag: an exception that escaped between
        the start of a pool-writing forward and the adoption of its pools
        leaves them half-written, the engine-fatal signature; a fault
        before the forward leaves them intact (per request)."""
        return self._pools_valid

    def contain_fault(self, exc: BaseException) -> str:
        """Classify and, where possible, contain an exception that escaped
        :meth:`step` (JAX ``engine.py:1579``). Returns ``"request"`` when
        the faulting action's request(s) were re-queued with logical-step
        backoff (or quarantined with ``req.error`` after
        ``serving.fault.max_request_retries``), ``"fatal"`` when the pools
        are half-written and the caller must :meth:`restart_engine` (or
        give up), or ``"unattributed"`` when nothing could be re-queued
        (the fault fired before an action was chosen). Either way the
        fault is recorded (``serve.fault`` event,
        ``serving/step_faults{kind=}``). ``generate_batch`` never calls
        this: it propagates."""
        kind, payload = self.last_action if self.last_action is not None \
            else ("unknown", None)
        site = self.fault_site if self.fault_site is not None else kind
        msg = f"{type(exc).__name__}: {exc}"
        if self.ev is not None:
            self.ev.emit("serve.fault", action=site, error=msg)
        if self.sched.telemetry is not None:
            self.sched.telemetry.step_faults.labels(kind=site).inc()
        logger.warning(f"serving step fault ({site}): {msg}")
        if not self.pools_alive():
            return "fatal"
        if kind in ("prefill", "prefill_chunk"):
            reqs = [payload]
        elif kind in ("decode", "verify"):
            # a fused step has no single culprit: every running row
            # re-queues and recomputes greedy-identically
            reqs = [r for r in payload if r.state == "running"]
        else:
            reqs = []
        if not reqs:
            return "unattributed"
        # reversed: each re-queue goes to the front, so the earliest
        # admitted request ends at the head of the queue
        for r in reversed(reqs):
            self._retry_or_quarantine(r, msg)
        self._flush_finished()
        return "request"

    def _retry_or_quarantine(self, req, msg: str) -> None:
        """JAX ``engine.py:1632``."""
        req.retry_count += 1
        if req.retry_count > self.fault_max_retries:
            self.sched.fail_request(
                req, f"quarantined after {self.fault_max_retries} "
                     f"step-fault retries: {msg}")
            return
        backoff = self.fault_backoff_steps * (1 << (req.retry_count - 1))
        self.sched.requeue_for_retry(req, backoff, error=msg)

    def restart_engine(self) -> None:
        """Engine recovery after an engine-fatal step fault (JAX
        ``engine.py:1642``): drop the half-written pools, build new pools
        and a new block allocator, and re-admit every in-flight request
        from prompt + generated tokens through
        :meth:`ContinuousBatchingScheduler.reset_pool`, the recovery that
        recompute-preemption already proves greedy-identical. The prefix
        cache starts cold."""
        engine, sched = self.engine, self.sched
        self._pending_spans.clear()         # their events timed dead work
        self.pools = None
        engine._paged_workspace = None      # frees the old pools first
        engine._paged_alloc = None
        pools, _ = engine._paged_pools(self.num_blocks, self.bs)
        alloc = engine._paged_allocator(self.num_blocks, self.bs, sched.prefix_caching, False)
        sched.reset_pool(alloc)
        self.pools = pools
        self._pools_valid = True

    def demote_prompt(self, tokens) -> int:
        """Force-demote a prompt's full blocks into the host KV tier (JAX
        ``engine.py:1717``). The port has no host tier yet (ROADMAP.md
        queue 1, tiered KV cache), so, as the JAX session without a spill
        hook, it demotes nothing and returns 0."""
        if self._closed:
            raise RuntimeError("serving session is closed")
        return 0

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.engine.device)

    def _to_host(self, t):
        """The loop's one device read a step (through the accelerator,
        which counts it); spans waiting for a read are resolved after it."""
        out = self.engine._acc.to_host(t).numpy()
        if self._pending_spans:
            self._flush_spans()
        return out

    def _sample(self, logits):
        """Host int64 tokens ``[B]``."""
        return self._to_host(self.engine._sample(logits, self.temperature, self.top_k,
                                                 self.generator))

    # ---- flight-recorder spans ---- #

    def _span(self, kind, rid, phase, t0, **data):
        """Emit one timed span that ended with a token read (``t0`` taken
        before its forward was dispatched), with its phase_ms sample."""
        dur = time.monotonic_ns() - t0
        self.ev.emit(kind, rid=rid, t_ns=t0, dur_ns=dur, **data)
        tel = self.sched.telemetry
        if tel is not None:
            tel.phase(phase, dur / 1e6, rid=rid)

    def _unread_span_start(self):
        """Start of a span the loop reads no token for (a COW copy, a
        non-final chunk): the host clock, plus a CUDA event on the card."""
        t0 = time.monotonic_ns()
        if self.engine.device.type != "cuda":
            return t0, None
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        return t0, e0

    def _unread_span_end(self, begun, kind, rid, phase, **data):
        """On the CPU the work is done: emit now. On the card, close the
        span with a second CUDA event and emit it after the next token
        read, its duration the device time between the two events.
        ``begun`` is :meth:`_unread_span_start`'s pair (``data`` may carry
        a ``start`` position)."""
        t0, e0 = begun
        if e0 is None:
            self._span(kind, rid, phase, t0, **data)
            return
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        self._pending_spans.append((kind, rid, phase, t0, e0, e1, data))

    def _flush_spans(self, wait: bool = False) -> None:
        tel = self.sched.telemetry
        for kind, rid, phase, t0, e0, e1, data in self._pending_spans:
            if wait:
                e1.synchronize()
            dur = int(e0.elapsed_time(e1) * 1e6)
            self.ev.emit(kind, rid=rid, t_ns=t0, dur_ns=dur, **data)
            if tel is not None:
                tel.phase(phase, dur / 1e6, rid=rid)
        self._pending_spans.clear()

    def _forward(self, site, fn, *args):
        """One pool-writing forward: the pools are marked half-written for
        its duration and adopted after the post-dispatch fault consult (a
        fault there leaves the session as a fault inside the forward
        would: engine-fatal). Returns what ``fn`` returns besides the
        pools."""
        self._pools_valid = False
        out = fn(*args)
        step_fault(site, "post")
        if isinstance(out, tuple):
            out, self.pools = out
        else:
            out, self.pools = None, out
        self._pools_valid = True
        return out

    @torch.no_grad()
    def _exec(self, action) -> None:
        engine, sched, model = self.engine, self.sched, self.engine.module
        cfg = model.config
        bs, n_max = self.bs, self.n_max
        ev = self.ev
        kind, payload = action
        self.actions[kind] += 1
        # serving fault injection (utils/fault_injection.fail_step, JAX
        # engine.py:1803): one None check a consult; "pre" fires before any
        # device work (per request), "post" after a forward, before its
        # pools are adopted (engine-fatal). The top consult ticks the
        # injector's step counter.
        self.fault_site = kind
        step_fault(kind, "pre", tick=True)
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
            t0 = time.monotonic_ns() if ev is not None else 0
            logits = self._forward("prefill", model.forward_paged_prefill,
                                   engine.params, self._tensor(toks, torch.long), self.pools,
                                   self._tensor(slots, torch.long), L - 1)
            tok = int(self._sample(logits)[0])
            if ev is not None:
                self._span("req.prefill", req.rid, "prefill", t0, tokens=L)
            sched.record_prefill(req, tok)
            self._emit_tokens(req, [tok])
        elif kind == "prefill_chunk":
            req = payload
            if req.cow_pending is not None:
                # copy-on-write split: the request restarts mid-block inside a
                # SHARED cached block — give it a private copy before it writes
                src, dst = req.cow_pending
                self.fault_site = "cow"
                step_fault("cow", "pre")
                span = self._unread_span_start() if ev is not None else None
                self._forward("cow", copy_paged_block, self.pools, src, dst)
                self.fault_site = kind
                if ev is not None:
                    self._unread_span_end(span, "req.cow_copy", req.rid, "cow", src=src, dst=dst)
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
            final = start + step == req.prefill_target
            span = None
            if ev is not None:
                span = (time.monotonic_ns(), None) if final else self._unread_span_start()
            logits = self._forward("prefill_chunk", model.forward_paged_prefill_chunk,
                                   engine.params, self._tensor(toks, torch.long), self.pools,
                                   self._tensor(bt, torch.int32),
                                   self._tensor(slots, torch.long), start, step - 1)
            if final:
                tok = int(self._sample(logits)[0])
                if ev is not None:
                    self._span("req.prefill_chunk", req.rid, "prefill_chunk", span[0],
                               start=start, tokens=step)
                sched.record_prefill_chunk(req, step, tok)
                self._emit_tokens(req, [tok])
            else:
                if ev is not None:
                    self._unread_span_end(span, "req.prefill_chunk", req.rid, "prefill_chunk",
                                          start=start, tokens=step)
                sched.record_prefill_chunk(req, step)
        elif kind == "decode":
            self._decode(payload)
        elif kind == "verify":
            self._verify(payload)
        else:
            raise ValueError(f"unknown scheduler action {kind!r}")

    def _decode(self, reqs) -> None:
        """One fused decode step over every running row. ``decode.tick`` is
        clocked from before the forward is dispatched until the sampled
        tokens are on the host."""
        engine, sched, model = self.engine, self.sched, self.engine.module
        W, n_max = self.W, self.n_max
        ev = self.ev
        bt = np.zeros((W, n_max), np.int32)       # zeros → dummy block
        pos = np.zeros((W,), np.int32)
        toks = np.zeros((W, 1), np.int64)
        for i, r in enumerate(reqs):
            bt[i, :len(r.blocks)] = r.blocks
            pos[i] = r.pos
            toks[i, 0] = r.last_token
        t0 = time.monotonic_ns() if ev is not None else 0
        logits = self._forward("decode", model.forward_paged_decode,
                               engine.params, self._tensor(toks, torch.long), self.pools,
                               self._tensor(bt, torch.int32), self._tensor(pos, torch.int32))
        tok = self._sample(logits)
        if ev is not None:
            # emitted BEFORE record_decode so a retirement this tick
            # triggers lands after its final decode slice
            dur = time.monotonic_ns() - t0
            ev.emit("decode.tick", t_ns=t0, dur_ns=dur, rids=[r.rid for r in reqs],
                    n=len(reqs))
            if sched.telemetry is not None:
                sched.telemetry.phase("decode", dur / 1e6)
        for i, r in enumerate(reqs):
            sched.record_decode(r, int(tok[i]))
            self._emit_tokens(r, [int(tok[i])])

    def _verify(self, reqs) -> None:
        """One speculative step: each request's window (its pending token
        and candidates, right-padded to ``spec_wb``) through
        ``forward_paged_verify``, greedy argmax at every window position,
        and acceptance of the longest candidate prefix the argmax agrees
        with plus the token at the first mismatch (cut at eos): the tokens
        that as many decode steps would emit."""
        engine, sched = self.engine, self.sched
        bs, W, n_max, wb = self.bs, self.W, self.n_max, self.spec_wb
        ev = self.ev
        bt = np.zeros((W, n_max), np.int32)       # zeros → dummy block
        pos = np.zeros((W,), np.int32)
        toks = np.zeros((W, wb), np.int64)
        slots = np.zeros((W, wb), np.int64)
        idle = np.zeros((1,), np.int32)
        for i in range(W):
            if i >= len(reqs):                    # idle rows write to the dummy block
                slots[i] = engine._flat_slots(idle, 0, 0, wb, bs)
                continue
            r = reqs[i]
            nv = 1 + len(r.spec_tokens)
            toks[i, 0] = r.last_token
            toks[i, 1:nv] = r.spec_tokens
            table = np.asarray(r.blocks, np.int32)
            bt[i, :table.size] = table
            pos[i] = r.pos
            slots[i] = engine._flat_slots(table, r.pos, nv, wb, bs)
        t0 = time.monotonic_ns() if ev is not None else 0
        logits = self._forward("verify", engine.module.forward_paged_verify,
                               engine.params, self._tensor(toks, torch.long), self.pools,
                               self._tensor(bt, torch.int32), self._tensor(slots, torch.long),
                               self._tensor(pos, torch.int32))
        # the decode step's own argmax (_sample at temperature 0), so ties break alike
        greedy = engine._sample(logits.reshape(W * wb, -1), 0.0, 0, None)
        greedy = self._to_host(greedy).reshape(W, wb)
        dur = time.monotonic_ns() - t0 if ev is not None else 0
        if ev is not None and sched.telemetry is not None:
            # one ledger sample per fused verify step
            sched.telemetry.phase("verify", dur / 1e6)
        for i, r in enumerate(reqs):
            cands = r.spec_tokens
            n_acc = 0
            while n_acc < len(cands) and int(greedy[i, n_acc]) == cands[n_acc]:
                n_acc += 1
            emitted = list(cands[:n_acc]) + [int(greedy[i, n_acc])]
            if r.eos is not None and int(r.eos) in emitted:
                emitted = emitted[:emitted.index(int(r.eos)) + 1]
            if ev is not None:
                # emitted BEFORE record_verify so a retirement this step
                # triggers lands after its slice
                ev.emit("req.spec_verify", rid=r.rid, t_ns=t0, dur_ns=dur,
                        window=1 + len(cands), accepted=len(emitted) - 1)
            sched.record_verify(r, emitted)
            self._emit_tokens(r, emitted)

    # ---- lifecycle ---- #

    def close(self) -> None:
        """Always-run bookkeeping: rid uniqueness across serves, the serve
        stats and action counts, releasing the engine's session slot."""
        if self._closed:
            return
        self._closed = True
        if self._pending_spans:
            # only when a serve stopped after a step with no token read
            self._flush_spans(wait=True)
        engine = self.engine
        engine._serve_rid_base = self.sched._next_rid
        engine._last_serve_stats = dict(self.sched.stats)
        engine._last_serve_actions = dict(self.actions)
        if engine._active_session is self:
            engine._active_session = None

    def end(self) -> None:
        """Success-path epilogue: hand the pools back to the engine's
        persistent workspace so the next serve reuses them (and, with prefix
        caching, re-hits this serve's blocks), and the memory gauges after
        the serve when telemetry is on."""
        engine = self.engine
        if engine._telemetry is not None:
            from deepspeed_tpu_torch.monitor.health import sample_memory_gauges
            sample_memory_gauges(engine._tel_reg, engine._acc)
        engine._paged_workspace = (self.num_blocks, self.bs, self.pools)
