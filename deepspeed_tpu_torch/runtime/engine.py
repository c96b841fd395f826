"""Training engine: the single-device training path of
``deepspeed_tpu/runtime/engine.py`` in PyTorch.

``DeepSpeedEngine.train_batch`` runs one global batch: ``gas`` micro-steps of
forward + backward, each micro-step's gradients added to fp32 accumulation
buffers and then released, and one optimizer update (``_apply_update``):
unscale by ``loss_scale * gas``, skip on an fp16 overflow, clip on the
pre-clip global norm, ``master <- master - lr * u`` per leaf with ``u`` the
optimizer's descent direction (one kernel E launch that writes the master
in place for the Adam family) and the scheduled lr taken before the step
counter moves, and the compute-dtype params refreshed from the masters in
place. LAMB's trust ratio spans one JAX leaf (all layers of a stacked leaf),
so it updates each group of per-layer leaves at once: the moments pass over
every leaf of the group, then the group's ratio on the device, then the
apply pass. With ``quantize_training`` enabled, ``train_batch`` then
fake-quantizes the compute-dtype params (MoQ, ``runtime/quantize.py``) as the
JAX engine's ``_quantize_step`` does. With ``gas == 1`` the micro-step's gradients feed the update directly
in the compute dtype, with no buffers, as the JAX engine's fused path does.
The ``forward`` / ``backward`` / ``step`` trio gives the same result.

``train_batch()`` without a batch draws ``gas`` micro-batches from a standing
stream: a ``set_dataiterator`` iterator, or the engine's own dataloader
(``training_data``, ``set_dataloader``; ``runtime/dataloader.py``) rolling
over epochs. ``save_checkpoint`` / ``load_checkpoint`` / ``auto_resume``
write and read the JAX package's crash-safe tags
(``runtime/checkpoint_engine/``), and a resume fast-forwards the data stream
to the recorded progress.

Where the JAX engine compiles the whole batch into one program over
immutable arrays, the port runs eagerly and updates in place: gradients
live in ``param.grad`` only until they are accumulated, and the update runs
leaf by leaf, so one unscaled fp32 gradient is alive at a time. The state is the JAX
``TrainState``'s fields as attributes of :class:`TrainState`.

A client optimizer (``initialize(..., optimizer=...)``) is a
``torch.optim.Optimizer``: a callable ``f(params) -> Optimizer`` that the
engine calls once over its fp32 masters (the fp32 params without mixed
precision) in the JAX flatten order (``runtime/utils.jax_leaves``: layers
in order within each stacked leaf), or an optimizer already built over the
tensors of ``model_parameters`` in that tree's flatten order, whose groups
the engine rebinds onto its masters by position (hyperparameters kept). Its
update is final, as a client optax chain's is in the JAX engine: the engine
unscales, skips on overflow and clips as for its own optimizers, sets every
master's ``.grad`` to its clipped fp32 gradient (so all of them are alive at
once), calls ``step()`` and never applies its own lr. It sees the port's
per-layer leaves, so an optimizer with per-tensor statistics (a LAMB-like
trust ratio) computes them per layer where the JAX engine's spans the
stacked leaf; elementwise optimizers and global norms match.

With ``telemetry`` on, ``train_batch`` records the JAX engine's series in
the metrics registry (``train/step_time_ms``, ``tokens_per_sec``,
``achieved_tflops_per_chip``, ``mfu``, ``loss``, ``grad_norm``,
``data_wait_ms``, ...) and, with ``telemetry.events``, a ``train.step``
event in the flight recorder. It pays one host sync a step for that: one
read of the loss and the pre-clip gradient norm through the accelerator.
``telemetry.health`` adds the health observatory (``monitor/health.py``):
its sentinel vector is gathered in the update (the bucket norms from the
grad norm's per-leaf norms; the update norm ``lr * ||u||`` from the update
vector, as the JAX engine takes it: kernel E writes each block's partial
``Σu²``, SGD / Lion / Adagrad the ``Σu²`` of the u they form, K7's ratio
kernel each LAMB group's ``ratio * ||u||``) and rides that same read. A
``torch.optim`` client exposes no update vector (a JAX client chain's
updates are final and readable; a torch optimizer's ``step()`` only writes
the params), so for a client the norm is ``||new - old||`` against a copy
of every master kept across its ``step()``.
``telemetry.metrics_port`` starts a ``/metrics`` exporter and
``telemetry.sampler`` / ``.slo`` the snapshot sampler with its SLO engine,
both stopped by ``destroy()``. With telemetry off, every hook is one None
check and a bf16 step makes no sync. ``wall_clock_breakdown`` times the
forward / backward / step trio between accelerator syncs.

Settings outside the port's slices (offload, the 1-bit optimizers,
pipeline and multi-device runs, ...) raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.config.core import DeepSpeedConfig
from deepspeed_tpu_torch.models.transformer import ParamTree, map_tree
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.loss_scaler import (LossScaleState, has_overflow,
                                                     make_loss_scale_state)
from deepspeed_tpu_torch.runtime.loss_scaler import update as scaler_update
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer, optimizer_momenta
from deepspeed_tpu_torch.runtime.quantize import quantizer_from_config
from deepspeed_tpu_torch.runtime.utils import (clip_grad_norm_, global_norm, jax_leaves,
                                               norm_of_norms)
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (NoopTimer, SynchronizedWallClockTimer,
                                             ThroughputTimer)

_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
           "bf16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """What one update reads and writes (the JAX engine's ``TrainState``)."""
    params: ParamTree                        # compute-dtype params (requires_grad)
    master: Optional[Dict[str, torch.Tensor]]  # fp32 masters by leaf name (None for fp32)
    opt_state: Any                           # the optimizer's state (runtime/optimizers.py)
    acc_grads: Optional[Dict[str, torch.Tensor]]  # accumulation buffers (None: gas 1)
    scaler: LossScaleState
    micro_steps: int = 0
    global_steps: int = 0
    skipped_steps: int = 0


def _loss_fn_of(model) -> Callable:
    if callable(model) and not hasattr(model, "loss"):
        fn = model
    elif hasattr(model, "loss"):
        fn = model.loss
    else:
        raise TypeError("model must be a loss callable loss_fn(params, batch[, rng]) or expose .loss")
    try:
        n_args = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_args = 2
    if n_args >= 3:
        return fn
    return lambda params, batch, rng: fn(params, batch)


class _Sentinels:
    """One update's sentinel parts, gathered on the device as the update
    runs (no host sync): per-leaf norms and non-finite counts of the
    unscaled pre-clip grads, the updated targets' norms and non-finite
    counts, and the update norm. An engine-built optimizer writes its
    update vector's squares into ``upd`` (the engine's one buffer, zeroed
    here): a row of partial ``Σu²`` a leaf, or, for LAMB (``upd_is_norm``),
    each group's ``ratio * ||u||`` in column 0; the norm is ``lr`` times
    their total, the JAX engine's ``lr * ||u||``
    (``deepspeed_tpu/runtime/engine.py:621-630``). A client optimizer
    (``upd`` None) passes ``new - old`` per leaf to :meth:`updated`.
    :meth:`vector` is the health module's sentinel layout."""

    def __init__(self, assignment, names, upd, upd_is_norm):
        self.assignment, self.names = assignment, names
        self.upd, self.upd_is_norm = upd, upd_is_norm
        if upd is not None:
            upd.zero_()
        self.lr = 0.0
        self.grad_norms, self.nf_grads = [], []
        self.param_norms, self.nf_params, self.update_norms = [], [], []

    def grad_leaf(self, g: torch.Tensor) -> torch.Tensor:
        nrm = torch.linalg.vector_norm(g, dtype=torch.float32)
        self.grad_norms.append(nrm)
        self.nf_grads.append(g.numel() - torch.isfinite(g).sum())
        return nrm

    def updated(self, new: torch.Tensor, delta: Optional[torch.Tensor] = None) -> None:
        """Account one leaf after the update; ``delta`` is a client
        optimizer's ``new - old``."""
        self.param_norms.append(torch.linalg.vector_norm(new, dtype=torch.float32))
        self.nf_params.append(new.numel() - torch.isfinite(new).sum())
        if delta is not None:
            self.update_norms.append(torch.linalg.vector_norm(delta, dtype=torch.float32))

    def vector(self, grad_norm) -> torch.Tensor:
        from deepspeed_tpu_torch.monitor.health import bucket_norms, compute_sentinels
        count = lambda xs: torch.stack(xs).sum().float()
        if self.upd is not None:
            total = (torch.linalg.vector_norm(self.upd) if self.upd_is_norm
                     else torch.sqrt(self.upd.sum()))
            update = total * self.lr
        elif self.update_norms:
            update = norm_of_norms(self.update_norms)
        else:
            update = torch.zeros_like(grad_norm)
        return compute_sentinels(
            count(self.nf_grads), count(self.nf_params), grad_norm,
            norm_of_norms(self.param_norms), update,
            bucket_norms(self.grad_norms, self.assignment, len(self.names)))


class DeepSpeedEngine:

    def __init__(self, model, config: Optional[Any] = None, model_parameters=None,
                 optimizer=None, lr_scheduler=None, training_data=None, collate_fn=None,
                 device=None):
        if optimizer is not None and not (isinstance(optimizer, torch.optim.Optimizer)
                                          or callable(optimizer)):
            raise TypeError("optimizer must be a torch.optim.Optimizer over model_parameters "
                            "or a callable params -> torch.optim.Optimizer")
        self.client_model = model
        self.loss_fn = _loss_fn_of(model)
        self._config = DeepSpeedConfig(config if config is not None else {},
                                       client_optimizer=optimizer is not None)
        # a JSON-level "fused_cross_entropy" beats the model config's default
        fce = self._config.fused_cross_entropy
        mcfg = getattr(model, "config", None)
        if fce is not None and mcfg is not None and hasattr(mcfg, "fused_cross_entropy"):
            model.config = dataclasses.replace(mcfg, fused_cross_entropy=fce)
            mcfg = model.config
        self.device = resolve_device(device)
        self._acc = get_accelerator(self.device.type)

        # ---- precision ----
        if self.bfloat16_enabled():
            self.compute_dtype = torch.bfloat16
        elif self.fp16_enabled():
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.mixed_precision = self.compute_dtype != torch.float32
        if (self.device.type == "cuda" and not self.mixed_precision
                and getattr(mcfg, "attention_backend", "auto") != "xla"):
            raise ValueError("the CUDA attention kernels take fp16/bf16: train with bf16 (or "
                             "fp16) enabled on the GPU")
        acc_name = self._config.gradient_accumulation_dtype
        # gas 1 feeds the micro-step grads straight to the update in compute
        # dtype; with gas > 1 grads accumulate in fp32 (the JAX engine's rule)
        if acc_name is None and self.gradient_accumulation_steps() == 1:
            self.grad_acc_dtype = self.compute_dtype
        else:
            self.grad_acc_dtype = _DTYPES[acc_name]

        # ---- optimizer ----
        self.client_optimizer = optimizer
        if optimizer is not None:
            # its updates are final: the engine's lr schedule never scales them
            self.tx = None
            self._optimizer_name = "client"
            if self._config.scheduler_name is not None:
                logger.warning("A client optimizer was passed together with a scheduler config; "
                               "the engine cannot inject the schedule into a finalized client "
                               "optimizer. Use optimizer config {'type': ...} or bake the "
                               "schedule into the client optimizer.")
        else:
            self.tx = build_optimizer(self._config.optimizer_name,
                                      self._config.optimizer_params)
            self._optimizer_name = self._config.optimizer_name or "adamw"

        # ---- MoQ (quantize_training) ----
        self.quantizer = (quantizer_from_config(self._config.quantize_training)
                          if self._config.quantize_training_enabled else None)
        self._moq_seen_skipped = 0

        # ---- lr schedule ----
        self.lr_scheduler = None
        base_lr = (self._config.optimizer_params or {}).get("lr", 1e-3)
        if lr_scheduler is not None and hasattr(lr_scheduler, "schedule_fn"):
            self._lr_fn = lr_scheduler.schedule_fn
            self.lr_scheduler = lr_scheduler
        elif callable(lr_scheduler):
            self._lr_fn = lr_scheduler
        elif self._config.scheduler_name is not None:
            params = self._config.scheduler_params or {}
            self._lr_fn = lr_schedules.get_lr_schedule_fn(self._config.scheduler_name, params)
            self.lr_scheduler = getattr(lr_schedules, self._config.scheduler_name)(**params)
        else:
            self._lr_fn = lambda step: base_lr

        # ---- fault tolerance: data-pipeline progress (recorded in every
        # checkpoint's meta.json so auto_resume can fast-forward the data
        # pipeline), the async checkpoint writer, the preemption handler ----
        self._data_progress = {"consumed_samples": 0, "iterations": 0}
        # True only for a user-provided set_dataiterator stream: resume
        # fast-forwards it in place; loader-derived iterators are instead
        # re-created by the epoch-aware resume_loader_iterator path
        self._data_iter_external = False
        self._data_iterator = None
        self._batch_fn = None
        self._ckpt_writer = None
        self._preemption = None
        self._training_mode = True

        # ---- dataloader ----
        self.training_dataloader = None
        if training_data is not None:
            from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=self.train_micro_batch_size_per_gpu(),
                collate_fn=collate_fn, drop_last=self._config.dataloader_drop_last)

        # ---- state ----
        if model_parameters is None:
            if not hasattr(model, "init_params"):
                raise ValueError("model_parameters is required (or model must expose init_params)")
            # seeded random init on the device (the JAX engine's key(0))
            gen = torch.Generator(device=self.device).manual_seed(0)
            model_parameters = model.init_params(gen, device=self.device)
        self.state = self._init_state(model_parameters)
        # dropout stream, seeded from DS_SEED as the JAX engine's key is
        self._rng_seed = int(os.environ.get("DS_SEED", 42))
        self._rng = torch.Generator().manual_seed(self._rng_seed)
        self._cached_loss = None
        self._losses = None
        self._global_grad_norm = None
        self._last_lr = None             # the lr of the last update
        self._skipped_before_step = None
        self._init_telemetry()
        ccfg = self._config.checkpoint_config
        if ccfg.preemption_save:
            self.enable_preemption_handler(ccfg.save_dir)
        log_dist(f"DeepSpeedEngine ready: optimizer={self._optimizer_name}, "
                 f"dtype={self.compute_dtype}, device={self.device}, "
                 f"micro_bs={self.train_micro_batch_size_per_gpu()} x "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    def _init_telemetry(self) -> None:
        """Timers, the monitor sinks and the telemetry series (the JAX
        engine's set). Off, ``_telemetry`` is None and every hot-path hook
        is one attribute check: no timers, no syncs, no registry traffic."""
        self.wall_clock_breakdown_enabled = bool(self._config.wall_clock_breakdown)
        self.timers = (SynchronizedWallClockTimer(accelerator=self._acc)
                       if self.wall_clock_breakdown_enabled else NoopTimer())
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size(),
                                          steps_per_output=self.steps_per_print(),
                                          accelerator=self._acc)
        self.monitor = MonitorMaster(self._config.monitor_config)
        tcfg = self._config.telemetry_config
        self._telemetry = tcfg if tcfg.enabled else None
        self._tel_flops_per_token_v = None
        self._host_global_steps = 0
        self._t_prev_step_end = None     # data-wait base
        self._trio_busy_s = 0.0          # per-cycle fwd+bwd+step phase time
        self._tel_wait_total = 0.0
        self._tel_busy_total = 0.0
        self._tel_events = None
        self._ev_skip_prev = None
        self._profiler = None
        # health observatory, /metrics exporter and sampler: None when off
        self._health = None
        self._sentinels_on = False
        self._sentinel_layout = None     # (leaf -> bucket, names, update buffer, is norm)
        self._sentinels = None           # the last update's sentinel vector
        self._tel_skipped_prev = None
        self._tel_exporter = None
        self._tel_sampler = None
        pcfg = tcfg.profile
        if pcfg.num_steps > 0:
            from deepspeed_tpu_torch.monitor.trace import ProfileWindow
            self._profiler = ProfileWindow(pcfg.dir, pcfg.start_step, pcfg.num_steps)
        if self._telemetry is None:
            return
        from deepspeed_tpu_torch.monitor.health import sample_memory_gauges
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        from deepspeed_tpu_torch.monitor.trace import get_compile_watchdog, get_tracer
        reg = get_registry()
        reg.set_enabled(True)
        self._tel_reg = reg
        self._tel_watchdog = get_compile_watchdog()
        self._tel_tracer = get_tracer()
        self._tel_sample_memory = sample_memory_gauges
        self._tel_step_hist = reg.histogram("train/step_time_ms", "whole train_batch wall time")
        self._tel_phase_hist = reg.histogram(
            "train/phase_time_ms",
            "fwd/bwd/step breakdown (forward()/backward()/step() trio)",
            labelnames=("phase",))
        self._tel_tokens_gauge = reg.gauge("train/tokens_per_sec",
                                           "tokens through the last step")
        self._tel_tflops_gauge = reg.gauge("train/achieved_tflops_per_chip",
                                           "model flops per token x token rate / chips")
        self._tel_mfu_gauge = reg.gauge("train/mfu",
                                        "achieved / peak flops per chip (PaLM-style)")
        self._tel_steps_counter = reg.counter("train/steps")
        self._tel_tokens_counter = reg.counter("train/tokens")
        self._tel_loss_gauge = reg.gauge("train/loss", "last recorded training loss")
        self._tel_grad_norm_hist = reg.histogram(
            "train/grad_norm",
            "pre-clip global gradient norm (computed for telemetry even with clipping off)")
        self._tel_wait_hist = reg.histogram(
            "train/data_wait_ms", "host time between steps (data loading + host prep)")
        self._tel_stall_gauge = reg.gauge("train/data_stall_fraction",
                                          "cumulative wait / (wait + device step) time")
        if self.fp16_enabled():
            self._tel_skipped_gauge = reg.gauge("train/skipped_steps",
                                                "fp16 overflow skip-update steps so far")
            self._tel_scale_gauge = reg.gauge("train/loss_scale", "current dynamic loss scale")
        if tcfg.events.enabled:
            from deepspeed_tpu_torch.monitor.events import get_flight_recorder
            self._tel_events = get_flight_recorder().enable(capacity=tcfg.events.capacity)
        hcfg = tcfg.health
        if hcfg.enabled:
            from deepspeed_tpu_torch.monitor.health import HealthMonitor, make_bucket_assignment
            self._health = HealthMonitor(hcfg, registry=reg, snapshot_fn=self.telemetry_snapshot,
                                         trace_export_fn=self._tel_tracer.export_chrome_trace)
            self._sentinels_on = bool(hcfg.sentinels)
            if self._sentinels_on:
                assignment, names = make_bucket_assignment(self._names, hcfg.max_norm_buckets)
                self._health.set_bucket_names(names)
                self._sentinel_layout = (assignment, names, *self._update_buffer())
        if tcfg.metrics_port is not None:
            from deepspeed_tpu_torch.monitor.exporter import MetricsExporter
            self._tel_exporter = MetricsExporter(reg, port=tcfg.metrics_port)
            ehost, eport = self._tel_exporter.start()
            logger.info(f"telemetry: /metrics exposition on http://{ehost}:{eport}/metrics")
        from deepspeed_tpu_torch.monitor.sampler import sampler_from_config
        sampler = sampler_from_config(tcfg, reg, self._tel_events)
        if sampler is not None:
            self._tel_sampler = sampler.start()

    def _update_buffer(self):
        """The sentinels' update-norm buffer and whether it holds norms:
        fp32 ``[groups, 1]`` of ``ratio * ||u||`` for LAMB, ``[leaves,
        slots]`` of partial ``Σu²`` for a leaf-wise optimizer (kernel E's
        blocks; one slot for SGD / Lion / Adagrad), None for a client
        optimizer."""
        if self.client_optimizer is not None:
            return None, False
        if self.tx.group_update is not None:
            return torch.zeros(len(self._groups), 1, device=self.device), True
        named = self._param_dict(self.state.params)
        slots = max(self.tx.sq_slots(p.numel()) for p in named.values())
        return torch.zeros(len(self._names), slots, device=self.device), False

    # ------------------------------------------------------------------ #
    # state

    def _init_state(self, model_parameters) -> TrainState:
        tree = model_parameters.to_dict() if isinstance(model_parameters, ParamTree) \
            else model_parameters
        dev = self.device
        params = ParamTree(map_tree(
            lambda a: torch.as_tensor(a).detach().to(dev, self.compute_dtype, copy=True), tree),
            requires_grad=True)
        self._names = [n for n, _ in params.named_parameters()]
        self._groups = list(jax_leaves(self._names).values())
        master = None
        if self.mixed_precision:
            fp32 = ParamTree(map_tree(
                lambda a: torch.as_tensor(a).detach().to(dev, torch.float32, copy=True), tree))
            master = {n: p.data for n, p in fp32.named_parameters()}
        target = master if master is not None else self._param_dict(params)
        opt_state = None
        if self.client_optimizer is not None:
            self.client_optimizer = self._bind_client_optimizer(self.client_optimizer, target)
        else:
            opt_state = self.tx.init(target)
        if self.fp16_enabled() and self._config.fp16_config.dynamic_loss_scale:
            args = self._config.dynamic_loss_scale_args
            scaler = make_loss_scale_state(init_scale=args["init_scale"],
                                           scale_window=args["scale_window"],
                                           min_scale=args["min_scale"],
                                           delayed_shift=args["delayed_shift"])
        elif self.fp16_enabled():
            scaler = make_loss_scale_state(init_scale=self._config.loss_scale or 1.0, dynamic=False)
        else:
            scaler = make_loss_scale_state(init_scale=1.0, dynamic=False)
        state = TrainState(params=params, master=master, opt_state=opt_state, acc_grads=None,
                           scaler=scaler)
        self.state = state
        if self._uses_acc_grad_buffers():
            self._ensure_acc_grads()
        return state

    @staticmethod
    def _param_dict(params: ParamTree) -> Dict[str, torch.Tensor]:
        return dict(params.named_parameters())

    def _bind_client_optimizer(self, optimizer, targets: Dict[str, torch.Tensor]):
        """The client optimizer over the engine's update targets (masters,
        or the fp32 params): a callable is called once over them in the JAX
        flatten order; an optimizer built over ``model_parameters`` (its
        tensors in that tree's flatten order) has every group's params
        rebound onto them by position, state and hyperparameters kept.
        Records the leaf names in the optimizer's param order."""
        if isinstance(optimizer, torch.optim.Optimizer):
            order = list(self._names)
            held = [p for g in optimizer.param_groups for p in g["params"]]
            if len(held) != len(order):
                raise ValueError(f"the client optimizer holds {len(held)} tensors, "
                                 f"model_parameters has {len(order)} leaves")
            for p, n in zip(held, order):
                if tuple(p.shape) != tuple(targets[n].shape):
                    raise ValueError(f"client optimizer tensor {order.index(n)} has shape "
                                     f"{tuple(p.shape)}, leaf {n} {tuple(targets[n].shape)}")
            k = 0
            for g in optimizer.param_groups:
                new = [targets[n] for n in order[k:k + len(g["params"])]]
                for old, t in zip(g["params"], new):
                    if old in optimizer.state:
                        optimizer.state[t] = optimizer.state.pop(old)
                g["params"] = new
                k += len(new)
        else:
            given = [n for names in self._groups for n in names]
            optimizer = optimizer([targets[n] for n in given])
            if not isinstance(optimizer, torch.optim.Optimizer):
                raise TypeError(f"the optimizer callable returned {type(optimizer).__name__}, "
                                "not a torch.optim.Optimizer")
            by_id = {id(targets[n]): n for n in given}
            held = [p for g in optimizer.param_groups for p in g["params"]]
            if any(id(p) not in by_id for p in held):
                raise ValueError("the client optimizer holds tensors the engine did not give it")
            order = [by_id[id(p)] for p in held]
        self._client_names = order
        return optimizer

    def _uses_acc_grad_buffers(self) -> bool:
        """Whether train_batch reads the accumulation buffers (gas > 1)."""
        return self.gradient_accumulation_steps() != 1

    def _ensure_acc_grads(self) -> None:
        """Allocate the accumulation buffers (gas > 1, or the trio)."""
        if self.state.acc_grads is None:
            self.state.acc_grads = {
                n: torch.zeros(p.shape, dtype=self.grad_acc_dtype, device=p.device)
                for n, p in self.state.params.named_parameters()}

    def load_train_state(self, params=None, master=None, opt_state=None,
                         global_steps: Optional[int] = None) -> None:
        """Carry a training state in (e.g. one taken from the JAX package
        with ``checkpoint.from_jax``): ``params`` a tree of the model's
        layout, ``master`` and the optimizer state's tensors by leaf name
        (an ``AdamState``, ``SGDState``, ``LionState`` or ``AdagradState``
        of the engine's optimizer). Values are copied into the engine's own
        tensors; what is not given stays."""
        named = self._param_dict(self.state.params)
        with torch.no_grad():
            if params is not None:
                tree = params.to_dict() if isinstance(params, ParamTree) else params
                src = dict(ParamTree(tree).named_parameters())
                for n, p in named.items():
                    p.copy_(src[n])
                if self.state.master is not None and master is None:
                    for n, m in self.state.master.items():
                        m.copy_(src[n])
            if master is not None:
                for n, m in self.state.master.items():
                    m.copy_(master[n])
                    named[n].copy_(m)
            if opt_state is not None:
                if self.client_optimizer is not None:
                    raise TypeError("a client optimizer's state loads through its own "
                                    "load_state_dict")
                mine = self.state.opt_state
                if type(opt_state) is not type(mine):
                    raise TypeError(f"{type(opt_state).__name__} given, the engine's "
                                    f"{self._optimizer_name} keeps a {type(mine).__name__}")
                for field in mine.FIELDS:
                    for n in self._names:
                        getattr(mine, field)[n].copy_(getattr(opt_state, field)[n])
                mine.count = int(opt_state.count)
        if global_steps is not None:
            self.state.global_steps = int(global_steps)

    # ------------------------------------------------------------------ #
    # the step's parts

    def _batch_to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, x in batch.items():
            t = torch.as_tensor(x)
            out[k] = t.to(self.device, torch.long if not t.is_floating_point() else t.dtype)
        return out

    def _micro_grads(self, batch) -> torch.Tensor:
        """Loss of one micro-batch; the loss-scaled grads land in the
        params' ``.grad`` (compute dtype)."""
        out = self.loss_fn(self.state.params, batch, self._rng)
        loss = out[0] if isinstance(out, tuple) else out
        (loss.float() * self.state.scaler.loss_scale).backward()
        return loss.detach()

    def _accumulate(self) -> None:
        """Add each leaf's ``.grad`` to its buffer and release it."""
        acc = self.state.acc_grads
        for n, p in self.state.params.named_parameters():
            g = p.grad
            if g is None:        # a leaf the loss does not reach: zero grad
                continue
            # a wider buffer adds the narrow grad exactly; a narrower one
            # rounds it first, as ``a + g.astype(acc_dtype)`` does
            acc[n].add_(g if acc[n].dtype in (g.dtype, torch.float32) else g.to(acc[n].dtype))
            p.grad = None

    def _apply_update(self, gas: int, grads: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Unscale, (fp16) skip on overflow, clip on the pre-clip global norm,
        update leaf by leaf (or, for a client optimizer, in one ``step()``),
        refresh the compute params from the masters in place. ``grads``:
        the gas == 1 micro-step grads; default the accumulation buffers,
        which are zeroed afterwards. With health sentinels on, the sentinel
        vector is gathered on the way (:class:`_Sentinels`)."""
        st = self.state
        from_buffers = grads is None
        denom = st.scaler.loss_scale * gas
        if from_buffers:
            # fp32 buffers are unscaled in place (they are zeroed after)
            grads = {n: (g.div_(denom) if g.dtype == torch.float32 else g.float() / denom)
                     for n, g in st.acc_grads.items()}
            unscaled = grads.__getitem__
        else:
            unscaled = lambda n: grads[n].float() / denom
        names = self._names
        overflow = bool(has_overflow(unscaled(n) for n in names)) if self.fp16_enabled() \
            else False
        clip = float(self.gradient_clipping() or 0.0)
        sen = _Sentinels(*self._sentinel_layout) if self._sentinels_on else None
        # the pre-clip norm: for clipping, and for the grad-norm series
        # (telemetry records it with clipping off too); the sentinels keep
        # its per-leaf norms for their buckets
        norm = None
        if sen is not None:
            norm = norm_of_norms([sen.grad_leaf(unscaled(n)) for n in names])
        elif clip > 0.0 or self._telemetry is not None:
            norm = global_norm(unscaled(n) for n in names)
        self._global_grad_norm = norm
        lr = float(self._lr_fn(st.global_steps))
        self._last_lr = lr
        params = self._param_dict(st.params)
        targets = st.master if st.master is not None else params
        if not overflow:
            def clipped(n):
                g = unscaled(n)
                if clip > 0.0:
                    clip_grad_norm_([g], clip, norm=norm)
                return g

            with torch.no_grad():
                if self.client_optimizer is not None:
                    self._client_step(clipped, targets, params, sen)
                elif self.tx.group_update is not None:
                    st.opt_state.count += 1
                    # one trust ratio per JAX leaf; the compute params are
                    # refreshed after the group's apply pass
                    for gi, group in enumerate(self._groups):
                        unorm = sen.upd[gi] if sen is not None else None
                        self.tx.group_update(st.opt_state, group, clipped, targets, lr,
                                             unorm=unorm)
                        for n in group:
                            if sen is not None:
                                sen.updated(targets[n])
                            if st.master is not None:
                                params[n].copy_(targets[n])
                else:
                    st.opt_state.count += 1
                    for i, n in enumerate(names):
                        sq = (sen.upd[i, :self.tx.sq_slots(targets[n].numel())]
                              if sen is not None else None)
                        self.tx.leaf_update(st.opt_state, n, clipped(n), targets[n], lr, sq=sq)
                        if sen is not None:
                            sen.updated(targets[n])
                        if st.master is not None:
                            params[n].copy_(targets[n])
                if sen is not None:
                    sen.lr = lr
        elif sen is not None:
            for n in names:     # an fp16 skip: params read as they stand, update norm 0
                sen.updated(targets[n])
        if sen is not None:
            self._sentinels = sen.vector(norm)
        st.scaler = scaler_update(st.scaler, overflow)
        if from_buffers:
            for g in st.acc_grads.values():
                g.zero_()
        st.global_steps += 1
        st.skipped_steps += int(overflow)

    def _client_step(self, clipped, targets, params, sen) -> None:
        """The client optimizer's update: every target's ``.grad`` set to its
        clipped fp32 gradient (all alive together), one ``step()``, the
        grads cleared, the compute params refreshed. With sentinels on, a
        full copy of the targets is kept across the step for the update
        norm: a torch optimizer exposes no update vector."""
        order = self._client_names
        for n in order:
            targets[n].grad = clipped(n)
        old = [targets[n].clone() for n in order] if sen is not None else None
        self.client_optimizer.step()
        for i, n in enumerate(order):
            targets[n].grad = None
            if sen is not None:
                sen.updated(targets[n], old[i].sub_(targets[n]))
                old[i] = None
            if self.state.master is not None:
                params[n].copy_(targets[n])

    # ------------------------------------------------------------------ #
    # public API

    def train_batch(self, batch=None, data_iter=None):
        """Run one full training batch (gas micro-steps + update). ``batch``
        is a dict whose leaves have leading dim ``gas * micro_bs``; without
        one, ``gas`` micro-batches come from ``data_iter``, the
        ``set_dataiterator`` stream, or the engine's dataloader. Returns the
        mean loss (a 0-dim tensor on the device)."""
        gas = self.gradient_accumulation_steps()
        micro_bs = self.train_micro_batch_size_per_gpu()
        expected = gas * micro_bs
        if batch is not None and self._batch_fn is not None:
            # the batch_fn normalizes the raw batch before any shape check
            batch = self._batch_fn(batch)
        if batch is not None:
            lead = next(iter(batch.values())).shape[0]
            if lead != expected:
                raise ValueError(
                    f"train_batch leading dim {lead} != gas({gas}) * micro_bs({micro_bs}) "
                    f"* dp(1) = {expected}")
            batch = {k: x.reshape((gas, -1) + tuple(x.shape[1:]))
                     for k, x in self._batch_to_device(batch).items()}
        else:
            micros = [next(self._standing_iterator(data_iter)) for _ in range(gas)]
            if self._batch_fn is not None:
                micros = [self._batch_fn(m) for m in micros]
            micros = [self._batch_to_device(m) for m in micros]
            batch = {k: torch.stack([m[k] for m in micros]) for k in micros[0]}
        self._skipped_before_step = self.state.skipped_steps
        self.tput_timer.start()
        prof = self._profiler
        if prof is not None:
            # profile-window boundary: starts/stops the capture
            prof.tick()
        t0 = time.perf_counter() if self._telemetry is not None else 0.0
        with (prof.annotate("train_batch") if prof is not None and prof.active
              else contextlib.nullcontext()):
            loss = self._train_batch_body(batch, gas)
        self.tput_timer.stop(global_step=True)
        self._data_progress["iterations"] += 1
        self._data_progress["consumed_samples"] += self.train_batch_size()
        self._losses = loss
        if self._telemetry is not None:
            self._tel_after_train_batch(batch, loss, t0)
        if self.quantizer is not None:
            self._quantize_step()
        self._write_monitor_events(loss)
        self._report_progress(loss)
        return loss

    def _train_batch_body(self, batch, gas: int) -> torch.Tensor:
        """gas micro-steps and the update; returns the mean loss."""
        if gas == 1:
            loss = self._micro_grads({k: x[0] for k, x in batch.items()})
            self.state.micro_steps += 1
            grads = {}
            for n, p in self.state.params.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                grads[n] = g.to(self.grad_acc_dtype)
                p.grad = None
            self._apply_update(1, grads)
            del grads
        else:
            self._ensure_acc_grads()
            losses = []
            for i in range(gas):
                losses.append(self._micro_grads({k: x[i] for k, x in batch.items()}))
                self._accumulate()
            self.state.micro_steps += gas
            self._apply_update(gas)
            loss = torch.stack(losses).mean()
        return loss

    def _standing_iterator(self, data_iter=None):
        """The micro-batch stream of a batchless ``train_batch``: ``data_iter``,
        else the ``set_dataiterator`` stream, else a standing stream over
        the engine's dataloader that rolls over epochs (the stream
        ``auto_resume``'s fast-forward rebuilds, so a resume is exact)."""
        if data_iter is not None:
            return data_iter
        if self._data_iterator is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs a batch, a data_iter, or engine training_data")
            from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
            self._data_iter_external = False
        return self._data_iterator

    def _quantize_step(self) -> None:
        """MoQ after the update (the JAX engine's ``_quantize_step``, run by
        ``train_batch`` only): walk the per-leaf bit schedule and
        fake-quantize the compute-dtype params in place, never the fp32
        masters. An fp16 overflow step skipped its update and does not
        advance the schedule."""
        overflow = False
        if self.fp16_enabled():
            cur = self.state.skipped_steps
            overflow = cur > self._moq_seen_skipped
            self._moq_seen_skipped = cur
        self.quantizer.quantize_tree(self._param_dict(self.state.params), overflow=overflow)

    def forward(self, batch):
        """Loss of one micro-batch, with its graph kept for ``backward``."""
        self.timers(SynchronizedWallClockTimer.FORWARD_GLOBAL_TIMER).start()
        t0 = time.perf_counter()
        out = self.loss_fn(self.state.params, self._batch_to_device(batch), self._rng)
        loss = out[0] if isinstance(out, tuple) else out
        self._tel_phase("fwd", t0)
        self.timers(SynchronizedWallClockTimer.FORWARD_GLOBAL_TIMER).stop()
        self._cached_loss = loss
        self._losses = loss.detach()
        return loss

    __call__ = forward

    def backward(self, loss=None, batch=None, allreduce_gradients=True, release_loss=False):
        """Back-propagate the loss of the last ``forward()`` (or of
        ``batch``, run here) at the loss scale and accumulate its grads."""
        if batch is not None:
            self.forward(batch)
        if self._cached_loss is None:
            raise RuntimeError("backward() called before forward(); pass batch= explicitly if needed")
        self.timers(SynchronizedWallClockTimer.BACKWARD_GLOBAL_TIMER).start()
        t0 = time.perf_counter()
        (self._cached_loss.float() * self.state.scaler.loss_scale).backward()
        self._cached_loss = None
        self._ensure_acc_grads()
        self._accumulate()
        self.state.micro_steps += 1
        self._tel_phase("bwd", t0)
        self.timers(SynchronizedWallClockTimer.BACKWARD_GLOBAL_TIMER).stop()
        return self._losses

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.state.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self, lr_kwargs=None):
        """Apply the optimizer update at the accumulation boundary (no-op
        otherwise)."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._skipped_before_step = self.state.skipped_steps
        self.timers(SynchronizedWallClockTimer.STEP_GLOBAL_TIMER).start()
        t0 = time.perf_counter()
        self._apply_update(self.gradient_accumulation_steps())
        self._tel_phase("step", t0)
        self.timers(SynchronizedWallClockTimer.STEP_GLOBAL_TIMER).stop()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self._telemetry is not None:
            self._host_global_steps += 1
            loss_v, norm_v, sen_v = self._tel_read(self._losses)
            self._tel_record_update(loss_v, norm_v)
            busy, wait = self._tel_trio_wait()
            if self._health is not None:
                self._observe_health(loss_v, norm_v, sen_v, busy, wait)
            self._tel_maybe_flush()
        self._write_monitor_events(self._losses)
        self._report_progress(self._losses)

    def eval_batch(self, batch):
        """Evaluation loss, deterministic (no dropout) and without grads."""
        with torch.no_grad():
            out = self.loss_fn(self.state.params, self._batch_to_device(batch), None)
        return out[0] if isinstance(out, tuple) else out

    def _report_progress(self, loss) -> None:
        spp = self.steps_per_print()
        if spp and self.state.global_steps % spp == 0:
            log_dist(f"step={self.state.global_steps}, skipped={self.state.skipped_steps}, "
                     f"lr={self.get_lr()}, loss={float(loss)}", ranks=[0])
            if self.wall_clock_breakdown_enabled:
                t = SynchronizedWallClockTimer
                self.timers.log([t.FORWARD_GLOBAL_TIMER, t.BACKWARD_GLOBAL_TIMER,
                                 t.STEP_GLOBAL_TIMER])

    # ------------------------------------------------------------------ #
    # monitoring and telemetry

    def _write_monitor_events(self, loss) -> None:
        """The monitor sinks' per-step scalars (JAX engine names). Reads the
        loss from the device, so only when a sink is on."""
        if not self.monitor.enabled:
            return
        step = self.global_steps
        events = [("Train/Samples/train_loss", float(self._acc.to_host(loss)), step),
                  ("Train/Samples/lr", self._last_lr, step)]
        if self.fp16_enabled():
            events.append(("Train/Samples/loss_scale", float(self.loss_scale), step))
        self.monitor.write_events(events)

    def _tel_read(self, loss):
        """The one host read of a telemetry-on update: the loss, the
        pre-clip grad norm and (health sentinels on) the sentinel vector in
        one tensor. Returns ``(loss, grad_norm or None, sentinels or None)``."""
        norm = self._global_grad_norm
        loss = loss.detach().float().reshape(())
        vals = torch.stack([loss, (norm if norm is not None else loss).detach().float()
                            .reshape(())])
        sen = self._sentinels if self._sentinels_on else None
        if sen is not None:
            vals = torch.cat([vals, sen.to(vals.device)])
        host = self._acc.to_host(vals).tolist()
        return host[0], (host[1] if norm is not None else None), \
            (host[2:] if sen is not None else None)

    def _tel_after_train_batch(self, batch, loss, t0: float) -> None:
        """The one host sync of a telemetry-on step (:meth:`_tel_read`), so
        the wall clock brackets the device work; then the step's series and
        the health detectors, before the flush, so a flush-step anomaly is in
        the snapshot it fired on."""
        loss_v, norm_v, sen_v = self._tel_read(loss)
        dt_s = time.perf_counter() - t0
        wait_s = t0 - self._t_prev_step_end if self._t_prev_step_end is not None else 0.0
        self._host_global_steps += 1
        self._tel_record_step(batch, dt_s, loss_v, norm_v, wait_s)
        if self._health is not None:
            self._observe_health(loss_v, norm_v, sen_v, dt_s, wait_s)
        self._tel_maybe_flush()
        self._t_prev_step_end = time.perf_counter()

    def _observe_health(self, loss: float, grad_norm: Optional[float],
                        sentinels: Optional[list], dt_s: float, wait_s: float) -> None:
        """Feed one update's record through the health detectors (host side:
        the sentinel values arrived with the step's one read)."""
        from deepspeed_tpu_torch.monitor.health import StepHealth, sentinel_to_dict
        rec = StepHealth(step=int(self.state.global_steps), loss=float(loss),
                         loss_scale=float(self.loss_scale), step_time_s=dt_s,
                         wait_time_s=wait_s)
        if grad_norm is not None:
            rec.grad_norm = float(grad_norm)
        if sentinels is not None:
            d = sentinel_to_dict(sentinels, self._health.bucket_names)
            rec.grad_norm = d["grad_norm"]
            rec.nonfinite_grads = d["nonfinite_grads"]
            rec.nonfinite_params = d["nonfinite_params"]
            rec.update_ratio = d["update_ratio"]
            rec.bucket_norms = tuple(d["bucket_norms"].values())
        if self.fp16_enabled():
            after = int(self.state.skipped_steps)
            prev = self._tel_skipped_prev
            if prev is None:
                before = self._skipped_before_step
                prev = int(before) if before is not None else after
            rec.skipped = after > prev
            self._tel_skipped_prev = after
        self._health.observe_step(rec)

    def health_report(self) -> Dict:
        """The health observatory's one-call summary (anomaly counts, EWMAs,
        skip and stall state, the last record, a memory sample);
        ``{"enabled": False}`` when ``telemetry.health`` is off."""
        if self._health is None:
            return {"enabled": False}
        return self._health.report()

    def _tel_phase(self, phase: str, t0: float) -> None:
        """Record one trio-phase duration (a sync, so the wall clock
        brackets the device work); telemetry off: nothing."""
        if self._telemetry is None:
            return
        self._acc.synchronize()
        dur = time.perf_counter() - t0
        self._tel_phase_hist.labels(phase=phase).observe(dur * 1e3)
        if self._tel_events is not None:
            dur_ns = int(dur * 1e9)
            self._tel_events.emit("train.phase", step=self._host_global_steps,
                                  t_ns=time.monotonic_ns() - dur_ns, dur_ns=dur_ns,
                                  phase=phase)
        self._trio_busy_s += dur

    def _tel_trio_wait(self):
        """Trio boundary: the wait is the boundary-to-boundary wall time
        the timed phases did not cover (data loading, host prep). Returns
        ``(busy_s, wait_s)``."""
        now = time.perf_counter()
        busy = self._trio_busy_s
        wall = now - self._t_prev_step_end if self._t_prev_step_end is not None else busy
        self._t_prev_step_end = now
        self._trio_busy_s = 0.0
        wait = max(wall - busy, 0.0)
        self._tel_account_wait(wait, busy)
        return busy, wait

    def _tel_account_wait(self, wait_s: float, busy_s: float) -> None:
        """The data-wait histogram plus the cumulative wait/(wait+busy)
        stall gauge."""
        wait_s = max(wait_s, 0.0)
        self._tel_wait_hist.observe(wait_s * 1e3)
        self._tel_wait_total += wait_s
        self._tel_busy_total += max(busy_s, 0.0)
        tot = self._tel_wait_total + self._tel_busy_total
        if tot > 0:
            self._tel_stall_gauge.set(self._tel_wait_total / tot)

    def _tel_record_step(self, batch, dt_s: float, loss: float, grad_norm: Optional[float],
                         wait_s: float) -> None:
        """Per-step series: step time, tokens/s, achieved TFLOP/s and MFU
        (PaLM-style: model flops a token x token rate / peak), data wait,
        and the update's loss / grad-norm / fp16 gauges."""
        self._tel_step_hist.observe(dt_s * 1e3)
        self._tel_steps_counter.inc()
        self._tel_tracer.add_event("train_batch", time.perf_counter() - dt_s, dt_s)
        if self._tel_events is not None:
            dur = int(dt_s * 1e9)
            self._tel_events.emit("train.step", step=self._host_global_steps,
                                  t_ns=time.monotonic_ns() - dur, dur_ns=dur)
        lead = next(iter(batch.values()))
        tokens = 1
        for d in lead.shape[:3] if lead.ndim >= 3 else lead.shape[:2]:
            tokens *= int(d)
        tps = tokens / max(dt_s, 1e-9)
        self._tel_tokens_gauge.set(tps)
        self._tel_tokens_counter.inc(tokens)
        achieved = tps * self._tel_flops_per_token(int(lead.shape[-1])) / 1e12
        self._tel_tflops_gauge.set(achieved)
        peak = self._tel_peak_tflops()
        self._tel_mfu_gauge.set(achieved / peak if peak > 0 else 0.0)
        self._tel_account_wait(wait_s, dt_s)
        self._tel_record_update(loss, grad_norm)

    def _tel_record_update(self, loss: float, grad_norm: Optional[float] = None) -> None:
        """The update's series: loss gauge, the pre-clip grad-norm
        histogram, and under fp16 the skipped-steps / loss-scale gauges
        and a ``train.fp16_skip`` event when the update was skipped (host
        counters in the port: no device read)."""
        import math
        self._tel_loss_gauge.set(float(loss))
        if grad_norm is not None and math.isfinite(grad_norm):
            self._tel_grad_norm_hist.observe(grad_norm)
        if self.fp16_enabled():
            skipped = int(self.state.skipped_steps)
            self._tel_skipped_gauge.set(skipped)
            self._tel_scale_gauge.set(self.loss_scale)
            if self._tel_events is not None:
                if self._ev_skip_prev is not None and skipped > self._ev_skip_prev:
                    self._tel_events.emit("train.fp16_skip", step=self._host_global_steps,
                                          skipped_total=skipped, loss_scale=self.loss_scale)
                self._ev_skip_prev = skipped

    def _tel_maybe_flush(self) -> None:
        """JSONL / MonitorMaster flush on the ``steps_per_snapshot``
        cadence, memory gauges sampled just before (every step under
        health: host-side allocator reads)."""
        tcfg = self._telemetry
        n = tcfg.steps_per_snapshot
        flush = bool(n) and self._host_global_steps % n == 0
        if flush or self._health is not None:
            self._tel_sample_memory(self._tel_reg, self._acc)
        if not flush:
            return
        if tcfg.jsonl_path:
            self._tel_reg.write_jsonl(tcfg.jsonl_path, step=self._host_global_steps)
        if tcfg.publish_to_monitor:
            self._tel_reg.publish(self.monitor, self._host_global_steps)

    def _tel_flops_per_token(self, seq_len: int) -> float:
        """Training flops per token at the batch's sequence length, the
        model's analytic ``flops_per_token`` (6 N plus the attention term);
        0 when the model has none. The JAX engine measures the forward
        through its flops profiler first and falls back to the same count."""
        cached = self._tel_flops_per_token_v
        if cached is None or cached[0] != seq_len:
            fpt = 0.0
            fn = getattr(self.module, "flops_per_token", None)
            if fn is not None:
                try:
                    fpt = float(fn(seq_len))
                except TypeError:
                    fpt = float(fn())
            cached = self._tel_flops_per_token_v = (seq_len, fpt)
        return cached[1]

    def _tel_peak_tflops(self) -> float:
        """MFU denominator: config > DS_PEAK_TFLOPS / the accelerator's
        device table > 0 (the gauge reads 0 rather than a made-up peak)."""
        p = float(self._telemetry.peak_tflops_per_chip or 0.0)
        return p if p > 0 else float(self._acc.peak_tflops())

    def telemetry_snapshot(self) -> Dict:
        """Whole-process registry snapshot plus the build watchdog's summary
        under ``"compile"``. Empty dict when telemetry is off."""
        if self._telemetry is None:
            return {}
        self._tel_sample_memory(self._tel_reg, self._acc)
        snap = self._tel_reg.snapshot()
        snap["compile"] = self._tel_watchdog.summary()
        return snap

    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the recorded host spans as chrome-trace JSON; returns the
        path, or None when telemetry is off."""
        if self._telemetry is None:
            return None
        path = path or self._telemetry.chrome_trace_path
        if not path:
            raise ValueError("no trace path: pass one or set telemetry.chrome_trace_path")
        return self._tel_tracer.export_chrome_trace(path)

    def profile(self, steps: int, log_dir: Optional[str] = None):
        """Arm an on-demand ``torch.profiler`` capture of the next ``steps``
        ``train_batch`` calls into ``log_dir`` (default
        ``telemetry.profile.dir``). Works with telemetry off; raises if a
        capture is running. Returns the armed window."""
        if self._profiler is None:
            from deepspeed_tpu_torch.monitor.trace import ProfileWindow
            self._profiler = ProfileWindow(log_dir or self._config.telemetry_config.profile.dir)
        self._profiler.arm(steps, log_dir=log_dir)
        return self._profiler

    # ------------------------------------------------------------------ #
    # the data pipeline

    def set_dataloader(self, loader) -> None:
        """Replace the training dataloader and start a standing iterator
        over it (successive batchless train_batch calls consume successive
        micro-batches)."""
        self.training_dataloader = loader
        self._data_iterator = iter(loader) if loader is not None else None
        self._data_iter_external = False
        # progress describes the data pipeline; a new pipeline starts at 0
        self._data_progress = {"consumed_samples": 0, "iterations": 0}

    def set_dataiterator(self, iterator) -> None:
        """A standing iterator yielding micro-batches for batchless
        train_batch calls."""
        self._data_iterator = iterator
        self._data_iter_external = iterator is not None
        self._data_progress = {"consumed_samples": 0, "iterations": 0}

    def set_batch_fn(self, fn) -> None:
        """Post-process every batch (or micro-batch from an iterator)
        before the step."""
        self._batch_fn = fn

    def _fast_forward_data(self, iterations: int) -> None:
        """Advance the data pipeline past ``iterations`` consumed
        train_batch calls (``iterations * gas`` micro-batches), so a resume
        neither replays nor skips batches: a ``set_dataiterator`` stream is
        advanced in place (create it fresh before ``auto_resume``); the
        engine's dataloader gets a standing stream at that position, its
        epoch seed replayed by counter."""
        micro = int(iterations) * self.gradient_accumulation_steps()
        if micro <= 0:
            return
        it = self._data_iterator
        if it is not None and (self._data_iter_external or self.training_dataloader is None):
            for _ in range(micro):
                next(it)
            log_dist(f"auto_resume: fast-forwarded data iterator by {micro} micro-batches",
                     ranks=[0])
            return
        if self.training_dataloader is None:
            logger.warning(
                f"auto_resume: {micro} micro-batches of recorded progress but no "
                f"engine-owned data pipeline to fast-forward; pass a freshly-created "
                f"iterator via set_dataiterator BEFORE auto_resume, or expect replayed batches")
            return
        from deepspeed_tpu_torch.runtime.dataloader import resume_loader_iterator
        self._data_iterator = resume_loader_iterator(self.training_dataloader, micro)
        self._data_iter_external = False
        log_dist(f"auto_resume: dataloader fast-forwarded by {micro} micro-batches", ranks=[0])

    # ------------------------------------------------------------------ #
    # checkpoints (the JAX package's crash-safe format)

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        asynchronous=None):
        """Two-phase crash-safe save. The device -> host snapshot is done
        when this returns; ``asynchronous`` (default the config's
        ``checkpoint.async_save``) leaves the persist to the background
        writer, otherwise the tag is durably on disk on return."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import save_engine_checkpoint
        return save_engine_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                      save_latest=save_latest, asynchronous=asynchronous)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False, strict=False,
                        load_data_progress=False):
        """Load a tag (default: the newest intact one under ``load_dir``),
        all or nothing. Returns ``(path, client_state)``, ``(None, {})``
        when there is nothing to load (unless ``strict``)."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import load_engine_checkpoint
        return load_engine_checkpoint(self, load_dir, tag=tag,
                                      load_optimizer_states=load_optimizer_states,
                                      load_module_only=load_module_only, strict=strict,
                                      load_data_progress=load_data_progress)

    def auto_resume(self, save_dir, tag=None, strict=False):
        """Restore params, masters, optimizer, loss scaler, RNG and counters
        from the newest intact tag under ``save_dir`` (walking back past
        corrupt or partial tags) and fast-forward the data pipeline to the
        recorded progress, so the resumed losses equal an uninterrupted
        run's. Returns ``(path, client_state)``; ``(None, {})`` when there
        is nothing to resume (a fresh start) unless ``strict``."""
        return self.load_checkpoint(save_dir, tag=tag, strict=strict, load_data_progress=True)

    def flush_checkpoints(self, timeout=None):
        """Block until every queued async checkpoint is durably committed.
        Raises the writer's error if a queued save failed."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain(timeout=timeout, raise_on_error=True)

    def emergency_save(self, save_dir):
        """Preemption-grace save: drain in-flight async saves (bounded, best
        effort), then one synchronous verified save of the current state."""
        if self._ckpt_writer is not None:
            try:
                self._ckpt_writer.drain(timeout=30)
            except Exception as e:
                logger.warning(f"emergency save: drain failed ({e}); "
                               f"taking the synchronous save anyway")
        result = self.save_checkpoint(save_dir, asynchronous=False)
        # the flight recorder's tail beside the tag: the post-mortem gets
        # the timeline leading into the signal (no-op when recording is off)
        from deepspeed_tpu_torch.monitor.events import dump_events_jsonl
        dump_events_jsonl(save_dir)
        return result

    def enable_preemption_handler(self, save_dir, signals=None, exit_on_signal=True):
        """Install the SIGTERM/SIGINT grace handler: on signal, drain the
        checkpoint writer, emergency-save to ``save_dir``, exit
        ``128+signum``."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import PreemptionHandler
        if self._preemption is not None:
            self._preemption.uninstall()
        kwargs = {} if signals is None else {"signals": tuple(signals)}
        self._preemption = PreemptionHandler(
            self, save_dir, exit_on_signal=exit_on_signal, **kwargs).install()
        return self._preemption

    def disable_preemption_handler(self):
        if self._preemption is not None:
            self._preemption.uninstall()
            self._preemption = None

    def _checkpoint_writer(self):
        """The engine's async writer, made on first use."""
        if self._ckpt_writer is None:
            from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (
                _checkpoint_cfg, _notify_ckpt_result)
            from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import (
                AsyncCheckpointWriter)
            ccfg = _checkpoint_cfg(self)
            self._ckpt_writer = AsyncCheckpointWriter(
                max_pending=ccfg.max_pending, retries=ccfg.retries,
                retry_backoff_s=ccfg.retry_backoff_s, keep_last=ccfg.keep_last,
                on_result=lambda ok, steps: _notify_ckpt_result(self, ok, steps))
        return self._ckpt_writer

    def save_16bit_model(self, save_dir, save_filename: str = "model_16bit.npz",
                         exclude_frozen_parameters: bool = False):
        """Write the module weights as one 16-bit flat-key .npz in the JAX
        package's layout (stacked layer leaves; fp32 rounded to bf16; bf16
        stored as raw bits under ``key::bf16``). Returns the path."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _nest
        from deepspeed_tpu_torch.utils.pytree import leaf_paths

        if exclude_frozen_parameters:
            raise NotImplementedError(
                "exclude_frozen_parameters: the functional engine has no "
                "frozen-parameter registry; filter the tree before saving")
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        tree = _nest(jax_leaves(self._names), self._param_dict(self.state.params))
        flat = {}
        for key, leaf in leaf_paths(tree).items():
            a = leaf.snapshot()
            if a.dtype == torch.float32:
                a = a.to(torch.bfloat16)
            if a.dtype == torch.bfloat16:
                flat[key + "::bf16"] = a.view(torch.int16).numpy().view(np.uint16)
            else:
                flat[key] = a.numpy()
        np.savez(path, **flat)
        log_dist(f"saved 16-bit model weights to {path}", ranks=[0])
        return path

    def save_fp16_model(self, save_dir, save_filename: str = "model_16bit.npz"):
        """Alias of save_16bit_model."""
        return self.save_16bit_model(save_dir, save_filename)

    # ------------------------------------------------------------------ #
    # the rest of the engine surface

    def zero_grad(self) -> None:
        """Zero the gradient-accumulation buffers and drop a pending
        forward's graph (between trio steps)."""
        if self.state.acc_grads is not None:
            for g in self.state.acc_grads.values():
                g.zero_()
        for p in self.state.params.parameters():
            p.grad = None
        self._cached_loss = None

    def set_train_batch_size(self, train_batch_size: int) -> None:
        """Change the global batch through the gradient-accumulation steps;
        the micro-batch size stays."""
        micro = self.train_micro_batch_size_per_gpu()
        if train_batch_size % micro:
            raise ValueError(
                f"Train batch size ({train_batch_size}) must be divisible by "
                f"micro-batch ({micro}) x data parallelism (1)")
        new_gas = train_batch_size // micro
        if new_gas < 1:
            raise ValueError(f"Train batch size ({train_batch_size}) must cover "
                             f"at least one micro-batch per dp rank ({micro})")
        self._config.train_batch_size = train_batch_size
        self._config.gradient_accumulation_steps = new_gas
        if new_gas > 1 and self._config.gradient_accumulation_dtype is None and \
                self.grad_acc_dtype != torch.float32:
            # an engine born at gas 1 accumulated in the compute dtype (no
            # buffers); gas > 1 accumulates in fp32, so reallocate
            self.grad_acc_dtype = torch.float32
            self.state.acc_grads = None
        if self._uses_acc_grad_buffers():
            self._ensure_acc_grads()

    def get_batch_info(self):
        """(train_batch_size, micro_batch_size, gradient_accumulation_steps)."""
        return (self.train_batch_size(), self.train_micro_batch_size_per_gpu(),
                self.gradient_accumulation_steps())

    def train(self, mode: bool = True):
        """Mode toggle kept for the reference surface: dropout is chosen per
        call (train_batch draws it, eval_batch never), so this records
        intent only."""
        self._training_mode = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def module_state_dict(self) -> ParamTree:
        """The module parameters (the compute-dtype tree)."""
        return self.state.params

    def load_module_state_dict(self, state_dict, strict: bool = True) -> None:
        """Replace the module parameters with ``state_dict`` (a ParamTree or
        its nested dict, the model's layout); the fp32 masters follow so the
        optimizer continues from the new weights. ``strict=False`` overlays
        only the leaves present in ``state_dict`` (by dotted name)."""
        tree = state_dict.to_dict() if isinstance(state_dict, ParamTree) else state_dict
        src = dict(ParamTree(tree).named_parameters())
        named = self._param_dict(self.state.params)
        if strict and (set(src) != set(named) or
                       any(tuple(src[n].shape) != tuple(p.shape) for n, p in named.items())):
            raise ValueError("state_dict structure does not match module parameters (pass "
                             "strict=False to overlay matching leaves only)")
        with torch.no_grad():
            for n, p in named.items():
                if n in src:
                    p.copy_(src[n])
                    if self.state.master is not None:
                        self.state.master[n].copy_(p)

    def destroy(self) -> None:
        """Stop the sampler, the /metrics exporter, the checkpoint writer and
        the preemption handler and drop the state: the engine is unusable
        afterwards."""
        self.disable_preemption_handler()
        if self._profiler is not None:
            self._profiler.stop()       # a dangling capture wedges the profiler
        if self._tel_sampler is not None:
            self._tel_sampler.stop()
            self._tel_sampler = None
        if self._tel_exporter is not None:
            self._tel_exporter.stop()
            self._tel_exporter = None
        if self._ckpt_writer is not None:
            self._ckpt_writer.stop()
            self._ckpt_writer = None
        self._cached_loss = None
        self._data_iterator = None
        self.state = None

    # ------------------------------------------------------------------ #
    # accessors

    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def gradient_clipping(self) -> float:
        return self._config.gradient_clipping

    def fp16_enabled(self) -> bool:
        return self._config.fp16_enabled

    def bfloat16_enabled(self) -> bool:
        return self._config.bfloat16_enabled

    def steps_per_print(self) -> int:
        return self._config.steps_per_print

    def zero_optimization(self) -> bool:
        return self._config.zero_optimization_stage > 0

    def zero_optimization_stage(self) -> int:
        return self._config.zero_optimization_stage

    def zero_enabled(self) -> bool:
        return self._config.zero_enabled

    def optimizer_name(self):
        return self._optimizer_name

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params

    def dynamic_loss_scale(self) -> bool:
        # static fp16 (loss_scale != 0) reports False, like the reference
        return self.fp16_enabled() and self._config.fp16_config.dynamic_loss_scale

    def get_type(self):
        """Optimizer type per param group (``"client"`` for a client
        optimizer)."""
        return [self._optimizer_name]

    def get_mom(self):
        """Momentum per param group: SGD's ``momentum``, the Adam family's
        and Lion's ``betas``; None for a client optimizer, as the JAX engine
        reports for a client optax chain."""
        return [optimizer_momenta(self._optimizer_name, self._config.optimizer_params)]

    def was_step_applied(self) -> bool:
        """True when the most recent boundary step updated params (not an
        fp16 overflow skip)."""
        if self._skipped_before_step is None:
            return False
        return self.state.skipped_steps == self._skipped_before_step

    @property
    def global_steps(self) -> int:
        return self.state.global_steps

    @property
    def micro_steps(self) -> int:
        return self.state.micro_steps

    @property
    def skipped_steps(self) -> int:
        return self.state.skipped_steps

    def get_lr(self):
        return [float(self._lr_fn(self.state.global_steps))]

    def get_global_grad_norm(self) -> Optional[float]:
        """The pre-clip global gradient norm of the last update (computed
        for clipping; None before the first update or with clipping off)."""
        return None if self._global_grad_norm is None else float(self._global_grad_norm)

    @property
    def loss_scale(self) -> float:
        return float(self.state.scaler.loss_scale)

    @property
    def module(self):
        return self.client_model

    @property
    def optimizer(self):
        """The client optimizer when one was given, else the engine-built one."""
        return self.client_optimizer if self.client_optimizer is not None else self.tx
