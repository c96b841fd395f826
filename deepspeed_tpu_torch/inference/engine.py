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

With ``serving.kv_host`` the session runs the tiered KV cache: the block
allocator's demotion hook (:meth:`_ServeSession._spill_block`) gathers a
cold block that allocation reclaims and hands it to the host pool
(``inference/kv_host_pool.py``), and an admission whose prefix walks onto a
demoted chain copies those blocks back (:meth:`_ServeSession._run_fetches`)
before its tail prefills (``kv.spill`` / ``kv.fetch`` spans). Engines that
share one host pool (``adopt_host_kv_pool``) are the replica router's KV
transport (``inference/router.py``).

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

``dtype="int8"`` is weight-only quantization (the JAX engine's int8
branch): the weight matrices are quantized once at init
(``quant.weight.q_groups`` groups over each row's last axis, the untied
``lm_head`` too) and rest as ``ops/quant.Quantized8`` leaves, int8 payloads
with fp32 scales; activations, caches and every other leaf run bf16, and
each matmul dequantizes its weight at use (the ``dequant_int8`` kernel on
the card).

An MoE model (``models/moe_lm.MoECausalLM``) serves at expert parallelism
1, as the JAX engine's MoE branch does: ``forward`` routes with eval
capacity and drops the aux loss, ``generate`` prefills through
``forward_cached`` with a ``valid`` mask (bucket padding takes no expert
capacity) and decodes through K5, and ``generate_batch`` takes the static
path (an MoE model does not page). ``moe.ep_size`` > 1 raises naming
ROADMAP.md's "MoE with ep > 1".

``zero.offload_param.device`` "cpu" or "nvme" is ZeRO-Inference (the JAX
engine's weight streaming): the layer weights leave the card for one
pinned host slab or one file a layer (``inference/zero_inference.py`` lays
each layer out as one byte range), and ``_streamed_step`` runs the embedding,
then each layer's ``cached_block`` on one of two device layer buffers, then
the head. Layer i+1's copy runs on a copy stream while block i computes
(and layer i+2's NVMe read on the aio threads); block i waits only on its
copy's event, and a copy into a buffer waits on the event of the block that
last read it, so the loop adds no host sync. ``generate`` takes the static
loop with this step in place of ``forward_cached``; ``generate_batch``
serves statically, and a serving session is refused.

Settings outside the port's slices raise ``NotImplementedError`` naming
the ROADMAP item that will bring them.
"""

from __future__ import annotations

import collections
import gc
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.inference.block_allocator import DUMMY_BLOCK, BlockAllocator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig, DtypeEnum
from deepspeed_tpu_torch.inference.kv_host_pool import KvHostPool, dtype_name
from deepspeed_tpu_torch.inference.scheduler import ContinuousBatchingScheduler, ServingTelemetry
from deepspeed_tpu_torch.inference.spec import NgramProposer
from deepspeed_tpu_torch.models.transformer import (ParamTree, copy_paged_block, key_mask_bias,
                                                    map_tree)
from deepspeed_tpu_torch.ops.quant import Quantized8, quantize_params, tree_nbytes
from deepspeed_tpu_torch.utils.fault_injection import step_fault
from deepspeed_tpu_torch.utils.logging import log_dist, logger, warn_once
from deepspeed_tpu_torch.utils.not_ported import not_ported


def host_to_device(t, device):
    """A host KV slice onto ``device`` for a fetch: on the card through a
    pinned staging buffer, so the H2D copy is asynchronous (the caching host
    allocator keeps the buffer until the copy has run); as is on the CPU."""
    if device.type != "cuda":
        return t
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return staged.to(device, non_blocking=True)


class InferenceEngine:

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params=None, device=None):
        self._config = config or DeepSpeedInferenceConfig()
        self._refuse_outside_slice(model)
        self.device = resolve_device(device)
        self._acc = get_accelerator(self.device.type)
        # int8 = weight-only quantization (JAX engine.py:42-50): activations
        # and caches run bf16, the weight matrices rest as int8 payloads with
        # fp32 group scales (ops/quant.py)
        self._weight_quant = DtypeEnum.from_any(self._config.dtype) == DtypeEnum.int8
        self.dtype = (torch.bfloat16 if self._weight_quant
                      else DtypeEnum.from_any(self._config.dtype).torch)
        cfg = getattr(model, "config", None)
        if (self.device.type == "cuda" and self.dtype == torch.float32
                and getattr(cfg, "attention_backend", "auto") != "xla"):
            raise ValueError("the CUDA attention kernels take fp16/bf16: serve with "
                             "dtype='bf16' (or 'fp16') on the GPU")
        if params is None:
            model, params = self._load_checkpoint(model)
        self.module = model
        self._is_moe = self._check_moe(model)
        if params is None:
            if not hasattr(model, "init_params"):
                raise ValueError("InferenceEngine needs params (or a model with init_params)")
            # seeded random init on the device (the JAX engine's key(0))
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init_params(gen, device=self.device, dtype=self.dtype)
        if self._weight_quant:
            params = self._quantize(model, params)
        params = self._init_streaming(model, params)
        # the int8 payloads stay int8 and their scales fp32 (JAX _is_qscale)
        self.params = params.map(
            lambda t: t.to_device(self.device) if isinstance(t, Quantized8) else
            t.to(device=self.device, dtype=self.dtype if t.is_floating_point() else t.dtype))
        self._workspace = None       # (B, Smax, cache): static generate's KV workspace
        self._paged_workspace = None
        self._paged_alloc = None     # persistent prefix-cache allocator
        # the host-RAM KV tier: content-addressed, so it outlives pool
        # workspaces and serves; only a geometry or dtype change rebuilds it
        self._kv_host_pool = None
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

    def _quantize(self, model, params):
        """The JAX engine's int8 branch (``engine.py:192-200``): the weight
        matrices quantized with ``quant.weight.q_groups`` groups (the untied
        ``lm_head`` too), in the weights' own precision before the cast, and
        the bytes at rest logged against bf16."""
        groups = max(1, int(self._config.quant.weight.q_groups))
        dense_bytes = sum(p.numel() * 2 for p in params.parameters())
        params = quantize_params(params, groups=groups,
                                 include_embed=not getattr(getattr(model, "config", None),
                                                           "tie_embeddings", True))
        log_dist(f"int8 weight-only quantisation: q_groups={groups}, "
                 f"{dense_bytes / 2**20:.0f} MiB (bf16) -> "
                 f"{tree_nbytes(params) / 2**20:.0f} MiB at rest", ranks=[0])
        return params

    def _refuse_outside_slice(self, model) -> None:
        c = self._config
        srv = c.serving
        if int(c.tensor_parallel.tp_size) > 1 or int(srv.tp) > 1 or int(c.mp_size) > 1:
            not_ported("tensor-parallel serving", "queue 1: sharded serving")

    # ------------------------------------------------------------------ #
    # ZeRO-Inference weight streaming: one layer on the card at a time

    def _init_streaming(self, model, params):
        """``zero.offload_param.device`` "cpu" or "nvme" (the JAX engine's
        branch, ``engine.py:203-326``): the layer weights leave ``params``
        for host RAM (one slab, pinned for the card at its exact size) or
        for one file a layer under ``nvme_path`` (written through the aio
        engine, read back into pinned staging), and two layer buffers on the
        engine's device take each layer in turn. Returns the params that
        stay resident (embedding, final norm, head)."""
        off = dict(self._config.zero or {}).get("offload_param", {}) or {}
        dev = str(off.get("device", "none")).lower()
        self._stream_weights = dev in ("cpu", "nvme")
        self._stream_nvme = dev == "nvme"
        self._host_layers = None
        self._swapper = None
        if not self._stream_weights:
            return params
        if self._stream_nvme and not off.get("nvme_path"):
            raise ValueError("offload_param device='nvme' requires nvme_path")
        tree = params.to_dict()
        if not (hasattr(model, "config") and "layers" in tree):
            raise ValueError("weight streaming needs a zoo-layout model "
                             "(.config + params['layers'] per layer)")
        if getattr(model.config, "norm_position", "pre") == "post":
            # the streamed path is the pre-LN cached_* blocks
            raise ValueError("weight streaming supports pre-LN models only "
                             "(norm_position='post' has no cached path)")
        if self._is_moe:        # the JAX engine's refusal (engine.py:224)
            raise NotImplementedError(
                "ZeRO-Inference weight streaming of MoE models is not implemented (the "
                "streamed block is the dense cached path)")
        from deepspeed_tpu_torch.inference.zero_inference import LayerLayout
        from deepspeed_tpu_torch.ops.aio import HostSlab
        cast = lambda t: t if isinstance(t, Quantized8) or not t.is_floating_point() \
            else t.to(self.dtype)
        layers = [map_tree(cast, lp) for lp in tree.pop("layers")]
        L = len(layers)
        layout = LayerLayout(layers[0])
        pin = self.device.type == "cuda"
        self._stream_layout = layout
        self._n_stream_layers = L
        if self._stream_nvme:
            swap_dir = self._make_swap_dir(str(off["nvme_path"]))
            from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper
            self._swapper = AsyncTensorSwapper(swap_dir)
            # the reads land in two pinned staging buffers, one a layer buffer
            self._stream_staging = [HostSlab(layout.stride, pin).bytes for _ in range(2)]
            for i, lp in enumerate(layers):
                layout.pack(lp, self._stream_staging[0])
                # one layer at a time: the staged copies never exceed a layer
                self._swapper.swap_out(f"L{i}", self._stream_staging[0])
                layers[i] = None
        else:
            self._host_layers = HostSlab(L * layout.stride, pin)
            for i, lp in enumerate(layers):
                layout.pack(lp, self._host_layers.bytes[i * layout.stride:(i + 1) * layout.stride])
                layers[i] = None
        # the card's two layer buffers, allocated once and viewed as layer trees
        self._stream_slots = [torch.empty(layout.nbytes, dtype=torch.uint8, device=self.device)
                              for _ in range(2)]
        self._stream_trees = [layout.unpack(b) for b in self._stream_slots]
        self._copy_stream = None
        self._copy_timing = None     # a list: (start, end) CUDA events of each layer copy
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device=self.device)
            self._slot_ready = [torch.cuda.Event() for _ in range(2)]
            self._slot_free = [torch.cuda.Event() for _ in range(2)]
        where = (f"on NVMe at {off['nvme_path']}" if self._stream_nvme
                 else "resident on host" + (" (pinned)" if pin else ""))
        log_dist(f"ZeRO-Inference streaming: {L} layers ({L * layout.nbytes / 2**20:.0f} MiB) "
                 f"{where}; the device holds two layers at a time (double-buffered)",
                 ranks=[0])
        return ParamTree(tree)

    def _make_swap_dir(self, nvme_path: str) -> str:
        """A unique per-engine swap dir under ``nvme_path`` (engines sharing
        a path must not overwrite each other's files) with its owner
        marker, removed when the engine is collected or the interpreter
        exits (``_swap_cleanup``); stale dirs of dead owners swept first."""
        import shutil
        import tempfile
        import weakref
        os.makedirs(nvme_path, exist_ok=True)
        self._sweep_stale_swap_dirs(nvme_path)
        swap_dir = tempfile.mkdtemp(dir=nvme_path, prefix="zero_inference_")
        with open(os.path.join(swap_dir, "owner.pid"), "w") as f:
            f.write(self._owner_marker())
        self._swap_dir = swap_dir
        self._swap_cleanup = weakref.finalize(self, shutil.rmtree, swap_dir, True)
        return swap_dir

    @staticmethod
    def _owner_marker() -> str:
        """``hostname:boot_id:pid_ns:pid``: a pid means something only inside
        its own host, boot and pid namespace, so the sweep below judges no
        marker from another scope."""
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                boot = f.read().strip()
        except OSError:
            boot = "-"
        try:
            pidns = os.readlink("/proc/self/ns/pid")
        except OSError:
            pidns = "-"
        import socket
        return f"{socket.gethostname()}:{boot}:{pidns}:{os.getpid()}"

    @classmethod
    def _sweep_stale_swap_dirs(cls, nvme_path: str) -> None:
        """Remove ``zero_inference_*`` dirs whose owner (in this scope) is
        dead: a killed process leaks a model-sized footprint the finalizer
        never removed. Unmarked dirs, live owners and other scopes stay."""
        import shutil
        me_scope, _ = cls._owner_marker().rsplit(":", 1)
        for name in os.listdir(nvme_path):
            d = os.path.join(nvme_path, name)
            if not (name.startswith("zero_inference_") and os.path.isdir(d)):
                continue
            try:
                with open(os.path.join(d, "owner.pid")) as f:
                    scope, pid = f.read().strip().rsplit(":", 1)
                pid = int(pid)
            except (OSError, ValueError):
                continue       # unmarked or mid-creation
            if scope != me_scope or pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)    # an existence probe
            except ProcessLookupError:
                logger.warning(f"sweeping stale ZeRO-Inference swap dir {d} "
                               f"(owner pid {pid} is dead)")
                shutil.rmtree(d, ignore_errors=True)
            except OSError:
                pass           # alive but not ours

    def _fetch_submit(self, i: int):
        """Start layer ``i``'s NVMe read into its pinned staging buffer (after
        that buffer's last copy to the card has run) and return a handle;
        RAM mode has nothing to start, so the handle is the index."""
        if self._swapper is None:
            return i
        s = i % 2
        if self._copy_stream is not None:
            self._slot_ready[s].synchronize()
        buf = self._stream_staging[s]
        self._swapper.swap_in(f"L{i}", out=buf, async_op=True)
        return buf

    def _fetch_finish(self, handle):
        """Layer bytes on the host: the read submitted by
        :meth:`_fetch_submit` waited for (one submit at a time: the wait is
        the swapper's), or layer ``handle``'s range of the host slab."""
        n = self._stream_layout.nbytes
        if self._swapper is None:
            off = handle * self._stream_layout.stride
            return self._host_layers.bytes[off:off + n]
        self._swapper.wait()
        return handle[:n]

    def _put_layer(self, i: int, host) -> int:
        """Copy one layer's host bytes into layer buffer ``i % 2`` and return
        the buffer's index. On the card the copy runs on the copy stream,
        from pinned memory, after the block that last read the buffer, and
        records the buffer's ready event."""
        s = i % 2
        if self._copy_stream is None:
            self._stream_slots[s].copy_(host)
            return s
        cs = self._copy_stream
        cs.wait_event(self._slot_free[s])
        with torch.cuda.stream(cs):
            if self._copy_timing is not None:
                self._copy_timing.append((torch.cuda.Event(enable_timing=True),
                                          torch.cuda.Event(enable_timing=True)))
                self._copy_timing[-1][0].record(cs)
            self._stream_slots[s].copy_(host, non_blocking=True)
            self._slot_ready[s].record(cs)
            if self._copy_timing is not None:
                self._copy_timing[-1][1].record(cs)
        return s

    def _stream_caches(self, B: int, Smax: int):
        return self.module.init_cache(B, Smax, dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def _streamed_step(self, tokens, cache, pos: int, pad_bias=None):
        """tokens ``[B, T]`` against ``cache`` at offset ``pos``: the embedding,
        then each layer's ``cached_block`` on its layer buffer, then the
        head. Double-buffered: before block i is dispatched, layer i+1's
        copy is queued and layer i+2's NVMe read submitted, so the disk, the
        copy engine and the card overlap; block i waits only on its copy's
        event. Returns ``(logits, cache)``; no host sync."""
        from deepspeed_tpu_torch.models.transformer import cached_block, cached_embed, cached_head
        cfg = self.module.config
        pos = int(pos)
        x, positions = cached_embed(cfg, self.params, tokens, pos, self.dtype)
        n = self._n_stream_layers
        cur = torch.cuda.current_stream(self.device) if self._copy_stream is not None \
            else None
        pending = self._fetch_submit(0)
        host = self._fetch_finish(pending)
        pending = self._fetch_submit(1) if n > 1 else None
        nxt = self._put_layer(0, host)
        for i in range(n):
            s, nxt = nxt, None
            if i + 1 < n:
                host = self._fetch_finish(pending)
                pending = self._fetch_submit(i + 2) if i + 2 < n else None
                nxt = self._put_layer(i + 1, host)
            if cur is not None:
                cur.wait_event(self._slot_ready[s])
            x = cached_block(cfg, x, self._stream_trees[s], cache["k"][i], cache["v"][i],
                             positions, pos, pad_bias)
            if cur is not None:
                self._slot_free[s].record(cur)
        return cached_head(cfg, self.params, x), cache

    def _check_moe(self, model) -> bool:
        """The JAX engine's MoE checks (``engine.py:66-82``, ``:148-171``):
        ``ep_size`` > 1 needs an MoE model whose expert count it divides,
        and the config's ``moe.type`` must match the model (a residual
        PR-MoE or not). Expert parallelism itself is not ported: ``ep_size``
        > 1 on an MoE model raises naming its ROADMAP item. Returns whether
        the model is an MoE model (the zoo ``MoECausalLM`` shape: ``.moe``
        and a routed MLP)."""
        c = self._config
        if isinstance(c.moe, bool):
            enabled, ep, moe_type = c.moe, max(1, int(c.ep_size)), c.moe_type
        else:
            enabled, moe_type = c.moe.enabled, c.moe.type
            ep = max(int(c.moe.ep_size), int(c.ep_size), 1)
        ep = ep if enabled else 1
        is_moe = hasattr(model, "moe") and hasattr(model, "_moe_mlp")
        if ep > 1 and not is_moe:
            raise ValueError(f"config.moe.ep_size={ep} but the model has no MoE layers; "
                             "remove the moe section or serve an MoE model")
        if not is_moe:
            return False
        n_experts = int(getattr(model.moe, "num_experts", 0))
        if ep > 1 and n_experts % ep:
            raise ValueError(f"moe.ep_size={ep} must divide the model's num_experts={n_experts}")
        residual = bool(getattr(model.moe, "use_residual", False))
        if residual != (moe_type == "residual"):
            raise ValueError(f"config moe.type={moe_type!r} but the model "
                             f"{'IS' if residual else 'is NOT'} a residual (PR-)MoE; set "
                             "moe.type accordingly")
        if ep > 1:
            not_ported(f"MoE inference with moe.ep_size={ep}", "queue 1: MoE with ep > 1")
        return True

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
        """Generation needs a causal LM: an encoder run autoregressively
        (bidirectional attention, or hidden states for logits) is refused,
        by its class or by a zoo config with ``causal=False`` (the JAX
        engine's check; ``BertConfig`` has no ``causal`` field, its
        ``zoo_cfg`` has)."""
        from deepspeed_tpu_torch.models.bert import BertModel
        from deepspeed_tpu_torch.models.clip import (CLIPTextEncoder, CLIPVisionEncoder,
                                                     DSClipEncoder)
        zoo_cfg = getattr(self.module, "zoo_cfg", getattr(self.module, "config", None))
        if (isinstance(self.module, (BertModel, CLIPTextEncoder, CLIPVisionEncoder,
                                     DSClipEncoder))
                or getattr(zoo_cfg, "causal", True) is False):
            raise ValueError(f"{type(self.module).__name__} is an encoder; {what} requires a "
                             "causal LM; use engine.forward for hidden states / MLM logits")

    def _paged_supported(self) -> bool:
        # an MoE model and a streamed one serve on the static path, as in
        # the JAX engine
        return (not self._is_moe and not self._stream_weights
                and hasattr(self.module, "forward_paged_decode")
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

    def _kv_host_pool_for(self, num_blocks: int, block_size: int, caching: bool):
        """The persistent host-RAM KV tier for the serving geometry, or None
        when ``serving.kv_host`` is off or prefix caching is (the tier is
        keyed by the cache's hash chains; JAX ``engine.py:826``)."""
        kh = self._config.serving.kv_host
        if not kh.enabled or not caching:
            return None
        if str(kh.spill) not in ("auto", "off"):
            raise ValueError(f"serving.kv_host.spill={kh.spill!r} (expected auto|off)")
        cfg = self.module.config
        shape = (cfg.n_layer, block_size, cfg.kv_heads, cfg.head_dim)
        cap = int(kh.max_host_blocks) or 4 * max(num_blocks - 1, 1)
        pool = self._kv_host_pool
        if pool is not None and pool.matches_geometry(shape, self.dtype) \
                and pool.max_blocks == cap:
            return pool
        pool = KvHostPool(cap, shape, self.dtype, telemetry=self._serving_tel)
        self._kv_host_pool = pool
        log_dist(f"tiered KV cache: host pool of {cap} blocks ({shape}, "
                 f"{pool.dtype}) attached behind the block allocator", ranks=[0])
        return pool

    def _serving_geometry(self):
        """``(num_blocks, block_size, n_max, caching)`` of a session opened
        now, from ``serving``."""
        srv = self._config.serving
        bs = int(srv.block_size)
        n_max = -(-self.module.config.max_seq // bs)     # block-table width
        num_blocks = int(srv.max_num_blocks) or (int(srv.max_running) * n_max + 1)
        caching = (hasattr(self.module, "forward_paged_prefill_chunk")
                   and str(srv.prefix_caching) != "off")
        return num_blocks, bs, n_max, caching

    def ensure_host_kv_pool(self):
        """The host KV tier for the current serving geometry, built without
        opening a session (``serve_main`` stands the replicas' shared pool up
        on the first engine this way; JAX ``engine.py:857``). None when
        ``serving.kv_host`` is off or the model cannot prefix-cache."""
        num_blocks, bs, _, caching = self._serving_geometry()
        return self._kv_host_pool_for(num_blocks, bs, caching)

    def adopt_host_kv_pool(self, pool) -> None:
        """Share another engine's host KV tier, the replicas' KV transport
        (``inference/router.py``): a prefill replica demotes a prompt's
        blocks into the shared pool and a decode replica's admission fetches
        them. The pool must match this engine's block slice shape and dtype
        (content addresses only carry between identical layouts); later
        sessions then use it instead of building their own (JAX
        ``engine.py:872``). None detaches."""
        if pool is None:
            self._kv_host_pool = None
            return
        cfg = self.module.config
        shape = (cfg.n_layer, int(self._config.serving.block_size), cfg.kv_heads,
                 cfg.head_dim)
        if not pool.matches_geometry(shape, self.dtype):
            raise ValueError(
                f"host KV pool geometry {pool.block_shape}/{pool.dtype} does not match "
                f"this engine's {shape}/{dtype_name(self.dtype)}: replicas can only share "
                "a tier when their serving geometry is identical")
        self._kv_host_pool = pool

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
        if self._stream_weights:
            # the mask as the cached blocks' key-side pad bias over the slots
            ids = self._ids(input_ids)
            cache = self._stream_caches(ids.shape[0], ids.shape[1])
            return self._streamed_step(ids, cache, 0, pad_bias=key_mask_bias(mask))[0]
        if self._is_moe:
            # eval routing (eval capacity, no jitter or RTS) and the aux loss
            # dropped: serving returns logits only
            return self.module.forward(self.params, self._ids(input_ids), mask, train=False)[0]
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
        if self._stream_weights:
            out = self._generate_cached(input_ids, max_new, temperature, top_k, gen,
                                        eos_token_id, forward=self._streamed_step)
        elif hasattr(self.module, "forward_cached") and hasattr(self.module, "init_cache"):
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
    def _generate_cached(self, input_ids, max_new, temperature, top_k, gen, eos_token_id,
                         forward=None):
        """Prefill the right-padded 128-bucket at pos 0, take the first token
        from the logits at the last prompt position, then one
        ``forward_cached`` per token at pos = prompt length + step. With an
        eos the loop reads one flag from the device per token to stop early
        (the JAX engine tests ``all(done)`` inside its device loop); without
        one it never syncs. ``forward(tokens, cache, pos)`` replaces
        ``forward_cached`` (weight streaming: :meth:`_streamed_step`, the
        JAX engine's ``_generate_streamed``)."""
        if max_new <= 0:
            return input_ids
        if forward is None:
            forward = lambda t, c, p, **kw: self.module.forward_cached(self.params, t, c, p, **kw)
        B, P = input_ids.shape
        cfg = self.module.config
        cache, Smax = self._kv_workspace(B, min(cfg.max_seq, P + max_new))
        bucket = self._bucket(P, Smax)
        toks = torch.zeros((B, bucket), dtype=torch.long, device=self.device)
        toks[:, :P] = input_ids
        kw = {}
        if self._is_moe:      # bucket padding never competes for expert capacity
            kw["valid"] = (torch.arange(bucket, device=self.device) < P).float().expand(B, bucket)
        logits, cache = forward(toks, cache, 0, **kw)
        first = self._sample(logits[:, P - 1, :], temperature, top_k, gen)
        out_cap = min(Smax, self._bucket(max_new, Smax))
        out = torch.zeros((B, out_cap), dtype=torch.long, device=self.device)
        out[:, 0] = first
        eos = -1 if eos_token_id is None else int(eos_token_id)
        done = first == eos if eos >= 0 else None
        tok, step = first, 1
        while step < max_new and not (done is not None and bool(done.all())):
            logits, cache = forward(tok[:, None], cache, P + step - 1)
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
        self._reject_encoders("a serving session")
        if self._active_session is not None:
            raise RuntimeError(
                "another serving session is active on this engine (an "
                "AsyncServingEngine loop, or a generate_batch in flight); "
                "drain/shutdown it before opening a new one")
        srv = self._config.serving
        if str(srv.paged) == "off" or not self._paged_supported():
            raise ValueError("a serving session needs the paged engine (zoo causal LM, not "
                             "weight-streaming / MoE, serving.paged != 'off'): the serving "
                             "loop has no static fallback")
        if max_new <= 0:
            raise ValueError("a serving session needs max_new >= 1")

        W = int(srv.max_running)
        num_blocks, bs, n_max, _ = self._serving_geometry()

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
        # the tiered KV cache: attach the persistent host tier and decide
        # whether this session demotes (spill) or only serves host hits
        host_pool = self._kv_host_pool_for(num_blocks, bs, caching)
        alloc.attach_host_pool(host_pool)
        kv_spill = host_pool is not None and str(srv.kv_host.spill) != "off"
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
            on_finish=on_finish, retain_finished=retain_finished, kv_spill=kv_spill)
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
                 on_tokens=None, on_finish=None, retain_finished=True, kv_spill=False):
        self.engine = engine
        self.sched = sched
        self.pools = pools
        # the tiered KV cache's demotion hook is session-scoped: it reads
        # this session's pools, so close() clears it
        self._kv_spill = kv_spill
        sched.allocator.set_spill(self._spill_block if kv_spill else None)
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
        sched.allocator.set_spill(None)     # the hook read the dead pools
        host_pool = sched.allocator.host_pool
        self.pools = None
        engine._paged_workspace = None      # frees the old pools first
        engine._paged_alloc = None
        # on the card a reference cycle out of the faulted forward can still
        # hold them (the card then held both pools through the rebuild)
        gc.collect()
        pools, _ = engine._paged_pools(self.num_blocks, self.bs)
        alloc = engine._paged_allocator(self.num_blocks, self.bs, sched.prefix_caching, False)
        # the content-addressed host tier lives in host RAM: it survives
        alloc.attach_host_pool(host_pool)
        sched.reset_pool(alloc)
        self.pools = pools
        self._pools_valid = True
        if self._kv_spill:
            alloc.set_spill(self._spill_block)

    # ---- tiered KV cache: demote (D2H) / fetch (H2D) ---- #

    def _spill_block(self, block: int, key: bytes) -> bool:
        """The allocator's demotion hook (JAX ``engine.py:1672``): gather
        ``block``'s per-layer k and v slices and hand them to the host pool,
        which starts their D2H copy. The gather is a clone queued on the
        serving stream at reclaim, before the new owner's forward writes
        into the block, so stream order reads the old content. Never
        raises an ``Exception``: a failure degrades to destroy-on-reclaim
        (the pool counts and warns)."""
        sched, ev = self.sched, self.ev
        hp = sched.allocator.host_pool
        if hp is None:
            return False
        prev_site = self.fault_site
        self.fault_site = "spill"    # a SimulatedCrash escaping reads "spill"
        try:
            step_fault("spill", "pre")
            t0 = time.monotonic_ns() if ev is not None else 0
            k = self.pools["k"][:, block].clone()
            v = self.pools["v"][:, block].clone()
            ok = hp.put(key, k, v)
        except Exception as e:  # noqa: BLE001 — a spill is best-effort cache
            # retention: it degrades, counted in serving/kv_host_errors
            hp._count_error("spill (gather)", e)
            self.fault_site = prev_site
            return False
        self.fault_site = prev_site
        if ok:
            if ev is not None:
                # the span covers the gather's dispatch and the copy's start:
                # the D2H itself overlaps the next steps, which is the point
                dur = time.monotonic_ns() - t0
                ev.emit("kv.spill", t_ns=t0, dur_ns=dur, blocks=1,
                        bytes=k.numel() * k.element_size() * 2, block=block)
                if sched.telemetry is not None:
                    sched.telemetry.phase("spill", dur / 1e6)
            if sched.telemetry is not None:
                sched.telemetry.kv_spills.inc()
        return ok

    def demote_prompt(self, tokens) -> int:
        """Force-demote ``tokens``'s committed full blocks into the host
        tier (:meth:`BlockAllocator.demote_chain`; JAX ``engine.py:1717``):
        the push half of the prefill-to-decode handoff. Returns the number
        of blocks demoted (0 without a spill hook)."""
        if self._closed:
            raise RuntimeError("serving session is closed")
        if not self._kv_spill:
            return 0
        return self.sched.allocator.demote_chain(tokens)

    def _run_fetches(self, req) -> None:
        """Land the admission's host-tier hits (JAX ``engine.py:1732``): copy
        each demoted ``[L, bs, KV, Hd]`` slice into the request's freshly
        allocated block, queued before any of the request's prefill reads
        it. Each promoted block registers under its chain key only now,
        with its content on the device, and its host entry is dropped (a
        key lives in one tier); the copy-on-write split's private copy (key
        None) stays unregistered and keeps its host entry. The ``kv.fetch``
        span is timed like the other spans with no token read of their own
        (CUDA events on the card), so it adds no host sync."""
        fetches = req.fetch_pending
        req.fetch_pending = []
        if not fetches:
            return
        prev_site = self.fault_site
        self.fault_site = "fetch"    # restored only on success: containment
        step_fault("fetch", "pre")   # labels a fault here "fetch"
        engine, sched, ev = self.engine, self.sched, self.ev
        alloc = sched.allocator
        span = self._unread_span_start() if ev is not None else None
        nbytes = ntokens = 0
        for dst, key, k_host, v_host, tokens in fetches:
            k, v = host_to_device(k_host, engine.device), host_to_device(v_host, engine.device)
            self._pools_valid = False
            self.pools["k"][:, dst].copy_(k)
            self.pools["v"][:, dst].copy_(v)
            step_fault("fetch", "post")
            self._pools_valid = True
            nbytes += 2 * k_host.numel() * k_host.element_size()
            ntokens += int(tokens)
            if key is not None:
                alloc.register(dst, key)
                if alloc.host_pool is not None:
                    alloc.host_pool.remove(key)
        if sched.telemetry is not None:
            # counted at landing, not admission: a preempt-before-fetch
            # re-admission must not count an H2D that never ran
            sched.telemetry.kv_fetch_hits.inc(len(fetches))
            if ntokens:
                sched.telemetry.kv_fetch_tokens.inc(ntokens)
        if ev is not None:
            self._unread_span_end(span, "kv.fetch", req.rid, "fetch",
                                  blocks=len(fetches), bytes=nbytes)
        self.fault_site = prev_site

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
            self._run_fetches(req)
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
            self._run_fetches(req)
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
        # the demotion hook reads this session's pools: a stale hook on the
        # persistent allocator would gather freed buffers
        self.sched.allocator.set_spill(None)
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
