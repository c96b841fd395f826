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
JAX engine's ``_quantize_step`` does, its periods stretched by the
per-block Hessian eigenvalues under ``quantize_training.eigenvalue``
(``runtime/eigenvalue.py``). A ``compression.CompressedModel`` trains as
any model does, and a JSON ``fused_cross_entropy`` reaches both of its
variants. With ``gas == 1`` the micro-step's gradients feed the update directly
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
stacked leaf; elementwise optimizers and global norms match. Under ZeRO
stages 1-3 a callable is called over the rank's segments of the leaves,
so such a statistic spans a segment.

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

With ``zero_optimization.offload_optimizer`` on ``cpu`` or ``nvme`` (the
JAX engine's ZeRO-Offload), the fp32 masters and the moments live on the
host or on NVMe in a :class:`~deepspeed_tpu_torch.runtime.zero.offload.HostOffloadOptimizer`
keyed by the JAX leaves, and the card keeps the compute-dtype params and
the accumulation buffers only (every step accumulates, gas 1 too). At the
boundary (:meth:`_host_step`, the JAX ``_host_step``) the buffers are
copied into one pinned host slab, unscaled by ``loss_scale * gas`` (the
grad norm for telemetry and the non-finite count for health taken in that
pass), the host library's ``cpu_adam`` / ``cpu_adagrad`` steps each JAX
leaf (overflow check and clip inside, as the JAX optimizer does) and writes
the bf16 params into a second pinned slab, which is copied back into the
params in place without a sync; the scaler, the counters and the lr
scheduler follow. A tag then carries ``offload_state_p0.npz`` in the JAX
layout.

The engine starts the world as the JAX engine does: ``comm.init_distributed``
(a process group when the launcher's variables are set: nccl on the card,
gloo for ``device="cpu"``) and the config's ``mesh`` over its ranks, and
logs the ZeRO rules' ``describe()``. With a process group it trains
data-parallel over the ``dp`` and ``fsdp`` axes (at world 1 too):
``train_batch`` takes the global batch, ``gas * micro * dp`` rows, and
each rank its block (the rows the JAX engine's sharding of the batch dim
gives its device; the engine's dataloader yields global micro-batches of
``micro * dp``); the reported loss is the dp mean. The accumulation
buffers are views of one flat buffer laid out in the flat units of
``runtime/zero/partition.py`` (``runtime/zero/state.flat_buffer``): at
stages 0 and 1 it is whole and one all-reduce averages it before the
update, so the clip norm and the fp16 overflow check (its flag
MAX-reduced besides) read the averaged grads. At stages 1-3 the
state is partitioned over the data-parallel ranks in flat units
(``runtime/zero/state.py``; ``runtime/zero/partition.py`` says which rank
holds what): each rank keeps the fp32 masters and the optimizer state of
its block of every unit and updates only those (the clip norm from the
group's summed partial squares, LAMB's partials summed over the group
before each trust ratio, the sentinels' sums reduced once), then one
all-gather a unit refreshes the compute params; from stage 2 the buffer
holds the rank's blocks only, and each micro-step's gradients are
reduce-scattered into it in its dtype; stage 3
also partitions the compute params (``PartitionedParams``: each unit
gathered on use by the model and its gradient reduce-scattered by the
gather's backward; built under ``zero.Init`` when no params are given). A
world of one rank partitions into whole units and gives stage 0's bits.
``save_checkpoint`` writes from rank 0 (under ZeRO every rank takes part in
gathering the same full files) and meets the other ranks at a barrier,
as ``save_16bit_model`` does;
``load_checkpoint`` re-partitions a tag for the loading world and stage.
The ``forward`` / ``backward`` / ``step`` trio and ``eval_batch`` take each
rank's own micro-batch, as torch's DDP does; ``step`` averages at the
boundary as ``train_batch`` does.

Settings outside the port's slices (the 1-bit optimizers, pipeline,
ZeRO-Offload over several ranks, ...) raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import deepspeed_tpu_torch.comm as dist
from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.compression.compress import CompressedModel
from deepspeed_tpu_torch.config.core import DeepSpeedConfig
from deepspeed_tpu_torch.models.transformer import ParamTree, map_tree
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue, hvp_model
from deepspeed_tpu_torch.runtime.loss_scaler import (LossScaleState, has_overflow,
                                                     make_loss_scale_state)
from deepspeed_tpu_torch.runtime.loss_scaler import update as scaler_update
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer, optimizer_momenta
from deepspeed_tpu_torch.runtime.quantize import quantizer_from_config
from deepspeed_tpu_torch.runtime.utils import (clip_grad_norm_, global_norm, jax_leaves,
                                               norm_of_norms)
from deepspeed_tpu_torch.runtime.zero.partition import ZeroShardingRules, build_units
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (Init, PartitionedParams,
                                                                   gather_window, unit_leaves,
                                                                   zero_group)
from deepspeed_tpu_torch.runtime.zero.state import ZeroState, flat_buffer
from deepspeed_tpu_torch.utils.not_ported import not_ported
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (NoopTimer, SynchronizedWallClockTimer,
                                             ThroughputTimer)

_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
           "bf16": torch.bfloat16}


def _world_size() -> int:
    import torch.distributed as tdist
    return tdist.get_world_size() if dist.has_process_group() else 1


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
        self.updated_names = []

    def grad_leaf(self, g: torch.Tensor) -> torch.Tensor:
        nrm = torch.linalg.vector_norm(g, dtype=torch.float32)
        self.grad_norms.append(nrm)
        self.nf_grads.append(g.numel() - torch.isfinite(g).sum())
        return nrm

    def updated(self, new: torch.Tensor, delta: Optional[torch.Tensor] = None,
                name: Optional[str] = None) -> None:
        """Account one leaf after the update; ``delta`` is a client
        optimizer's ``new - old``; ``name`` the leaf's (for :meth:`reduce`)."""
        self.updated_names.append(name)
        self.param_norms.append(torch.linalg.vector_norm(new, dtype=torch.float32))
        self.nf_params.append(new.numel() - torch.isfinite(new).sum())
        if delta is not None:
            self.update_norms.append(torch.linalg.vector_norm(delta, dtype=torch.float32))

    def reduce(self, all_names, local_names, group) -> None:
        """Under ZeRO over several ranks: the per-leaf lists, kept for this
        rank's segments (``local_names``), become every leaf's (``all_names``,
        the bucket assignment's order) through one all-reduce of their
        squares and counts; a leaf-wise optimizer's ``Σu²`` rows are summed
        with them (LAMB's ``ratio * ||u||`` is the group's already)."""
        L = len(all_names)
        dev = self.upd.device if self.upd is not None else \
            (self.param_norms[0].device if self.param_norms else torch.device("cpu"))
        pos = {n: i for i, n in enumerate(all_names)}

        def index(order):
            return torch.tensor([pos[n] for n in order], dtype=torch.long, device=dev)
        cols = [(self.grad_norms, local_names), (self.nf_grads, local_names),
                (self.param_norms, self.updated_names), (self.nf_params, self.updated_names),
                (self.update_norms, self.updated_names)]
        squared = (True, False, True, False, True)
        v = torch.zeros(5, L, dtype=torch.float32, device=dev)
        for row, ((xs, order), sq) in enumerate(zip(cols, squared)):
            if xs:
                x = torch.stack([t.float().to(dev) for t in xs])
                v[row].index_copy_(0, index(order), x * x if sq else x)
        flat = v.reshape(-1)
        if self.upd is not None and not self.upd_is_norm:
            flat = torch.cat([flat, self.upd.reshape(-1)])
        flat = dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        v = flat[:5 * L].reshape(5, L)
        if self.upd is not None and not self.upd_is_norm:
            self.upd.copy_(flat[5 * L:].reshape(self.upd.shape))
        self.grad_norms = list(torch.sqrt(v[0]))
        self.nf_grads = list(v[1])
        self.param_norms = list(torch.sqrt(v[2]))
        self.nf_params = list(v[3])
        if self.update_norms:
            self.update_norms = list(torch.sqrt(v[4]))

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
                 device=None, mpu=None):
        if optimizer is not None and not (isinstance(optimizer, torch.optim.Optimizer)
                                          or callable(optimizer)):
            raise TypeError("optimizer must be a torch.optim.Optimizer over model_parameters "
                            "or a callable params -> torch.optim.Optimizer")
        self.client_model = model
        self.loss_fn = _loss_fn_of(model)
        self.device = resolve_device(device)
        self._acc = get_accelerator(self.device.type)

        # ---- the world and its mesh (the JAX engine's start-up): a process
        # group when the launcher's variables are set (nccl on the card,
        # gloo on the CPU), the config's mesh over its ranks ----
        dist.init_distributed(dist_backend="gloo" if self.device.type == "cpu" else "nccl",
                              verbose=False)
        dp_world = (dist.get_world_size(dist.data_parallel_axes(dist.get_mesh())) if dist.has_mesh()
                    else _world_size())
        if mpu is not None:
            # the reference contract (JAX config/core.py:141-145): the data
            # parallel world is the mpu's
            dp_world = self._mpu_world(mpu, dp_world)
        self._config = DeepSpeedConfig(config if config is not None else {}, world_size=dp_world,
                                       client_optimizer=optimizer is not None)
        dist.configure(self._config)
        self.mesh = dist.get_mesh() if dist.has_mesh() else dist.init_mesh(self._config.mesh_axes)
        self._init_data_parallel()
        self._init_zero(model, optimizer, mpu)
        # a JSON-level "fused_cross_entropy" beats the model config's default
        fce = self._config.fused_cross_entropy
        mcfg = getattr(model, "config", None)
        if isinstance(model, CompressedModel):
            # the wrapped model's config; both variants that the compression
            # schedule switches between take the override
            mcfg = getattr(model, "config_model", None)
            if fce is not None and hasattr(mcfg, "fused_cross_entropy"):
                model.replace_model_config(fused_cross_entropy=fce)
                mcfg = model.config_model
        elif fce is not None and mcfg is not None and hasattr(mcfg, "fused_cross_entropy"):
            model.config = dataclasses.replace(mcfg, fused_cross_entropy=fce)
            mcfg = model.config

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
        self.eigenvalue = None
        ev = (self._config.quantize_training.get("eigenvalue") or {}) if self.quantizer else {}
        if ev.get("enabled", False):
            self.eigenvalue = Eigenvalue(
                verbose=ev.get("verbose", False),
                max_iter=ev.get("max_iter", 100),
                tol=ev.get("tol", 1e-2),
                stability=ev.get("stability", 1e-6),
                gas_boundary_resolution=ev.get("gas_boundary_resolution", 1))
            self._ev_layer_name = ev.get("layer_name", "layers")
            self._ev_layer_num = ev.get("layer_num", 0)

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
                training_data, batch_size=self.train_micro_batch_size_per_gpu() * self.dp_world_size,
                collate_fn=collate_fn, drop_last=self._config.dataloader_drop_last)

        # ---- state ----
        self._offload = None             # the host optimizer under ZeRO-Offload
        if model_parameters is None:
            if not hasattr(model, "init_params"):
                raise ValueError("model_parameters is required (or model must expose init_params)")
            # seeded random init on the device (the JAX engine's key(0));
            # partitioned at stage 3, as the JAX engine builds under zero.Init
            gen = torch.Generator(device=self.device).manual_seed(0)
            with (Init(mesh=self.mesh, config=self._config.zero_config)
                  if self._zero_mode and self.zero_optimization_stage() >= 3
                  else contextlib.nullcontext()):
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
        self._init_data_efficiency()
        ccfg = self._config.checkpoint_config
        if ccfg.preemption_save:
            self.enable_preemption_handler(ccfg.save_dir)
        log_dist(f"DeepSpeedEngine ready: optimizer={self._optimizer_name}, "
                 f"dtype={self.compute_dtype}, device={self.device}, "
                 f"micro_bs={self.train_micro_batch_size_per_gpu()} x "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    def _init_data_parallel(self) -> None:
        """The data-parallel group: the mesh's data axes, their size and this
        rank's index along them. ``_dp`` (the axes) is set only with a
        process group, and then the gradients are averaged over it at every
        boundary, at one rank too; without one there is nothing to average."""
        self._dp_axes = tuple(dist.data_parallel_axes(self.mesh))
        self.dp_world_size = dist.get_world_size(self._dp_axes)
        coords = self.mesh.coords(dist.get_rank())
        rank = 0
        for ax in self._dp_axes:
            rank = rank * self.mesh.shape[ax] + coords[ax]
        self.dp_rank = rank
        self._dp = self._dp_axes if dist.has_process_group() else None
        self._flat_grads = None

    @staticmethod
    def _mpu_world(mpu, dp_world: int) -> int:
        """The data-parallel world an ``mpu`` names (reference contract;
        JAX ``config/core.py:141-145``), which must be this process's
        group; a model-parallel world above 1 is not ported."""
        mp = int(getattr(mpu, "get_model_parallel_world_size", lambda: 1)())
        if mp > 1:
            not_ported(f"model parallelism over {mp} ranks (mpu)",
                       "queue 1: tensor-parallel training")
        world = int(mpu.get_data_parallel_world_size())
        if world != dp_world:
            raise ValueError(f"mpu.get_data_parallel_world_size() is {world}, but this "
                             f"process's data-parallel group has {dp_world} ranks")
        return world

    def _init_zero(self, model, optimizer, mpu) -> None:
        """The ZeRO rules over the mesh, logged as the JAX engine logs them.
        With a process group at stage >= 1 (and no ZeRO-Offload) the state
        is partitioned over the data-parallel axes (``_zero_mode``;
        ``runtime/zero/state.py``); without one every stage replicates, as
        the JAX rules do over a mesh of one device. Refuses what the
        partitioned engine does not port."""
        self.mpu = mpu
        self.zero_rules = ZeroShardingRules(self.mesh, self._config.zero_config)
        log_dist(self.zero_rules.describe(), ranks=[0])
        stage = self.zero_rules.stage
        self._zero = None
        self._zero_mode = (self._dp is not None and stage >= 1
                           and self._config.offload_optimizer_device not in ("cpu", "nvme"))
        if not self._zero_mode:
            return
        self._zero_group = zero_group(self.mesh, self.zero_rules)
        if set(self._zero_group) != set(self._dp_axes):
            not_ported(f"ZeRO partitioning over {self._zero_group} where the batch splits over "
                       f"{tuple(self._dp_axes)}", "queue 1: hybrid ZeRO partitioning")
        if stage >= 3 and (self._config.quantize_training_enabled
                           or isinstance(model, CompressedModel)):
            not_ported("MoQ, compression and the eigenvalue schedule under ZeRO stage 3",
                       "queue 1: MoQ and compression under ZeRO-3")
        if isinstance(optimizer, torch.optim.Optimizer) and \
                dist.get_world_size(self._zero_group) > 1:
            not_ported("a client optimizer built over model_parameters under ZeRO stages 1-3 "
                       "over several ranks (pass a callable)",
                       "queue 1: client optimizer state under ZeRO")

    def _rank_block(self, x, lead: int):
        """This rank's block of a global batch leaf ``[gas * micro * dp,
        ...]`` (``lead`` = gas) or micro-batch leaf ``[micro * dp, ...]``
        (``lead`` = None): the rows the JAX engine's sharding of the batch
        dim over dp gives device ``dp_rank``, as ``[gas, micro, ...]`` or
        ``[micro, ...]``."""
        micro = self.train_micro_batch_size_per_gpu()
        lo = self.dp_rank * micro
        if lead is None:
            return x[lo:lo + micro]
        return x.reshape((lead, -1) + tuple(x.shape[1:]))[:, lo:lo + micro]

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
        self.flops_profiler = None      # the FlopsProfiler of flops_profiler.profile_step
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
            # the sentinels ride the device update; the host optimizer's
            # pass counts the non-finite grads instead (the JAX offload path)
            self._sentinels_on = bool(hcfg.sentinels) and self._offload is None
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

    def _init_data_efficiency(self) -> None:
        """The curriculum (the JAX engine's legacy ``curriculum_learning``
        section, or ``data_efficiency.data_sampling.curriculum_learning`` with
        its parent switches as gates) and progressive layer drop, which the
        engine builds and nothing in it updates (as in the JAX engine: the
        user calls ``progressive_layer_drop.update_state(step)``)."""
        self.curriculum_scheduler = None
        self._curriculum_metric = None
        raw = self._config._param_dict
        legacy = raw.get("curriculum_learning", {})
        de = self._config.data_efficiency_config
        sampling = de["data_sampling"]
        curr_cfg = None
        if isinstance(legacy, dict) and legacy.get("enabled", False):
            curr_cfg = legacy
        elif de["enabled"] and sampling["enabled"] and \
                sampling["curriculum_learning"].get("enabled", False):
            curr_cfg = sampling["curriculum_learning"]
        if curr_cfg is not None:
            from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import (
                CurriculumScheduler)
            self.curriculum_scheduler = CurriculumScheduler(dict(curr_cfg))
            self._curriculum_metric = curr_cfg.get("curriculum_type", "seqlen")
        self.progressive_layer_drop = None
        if self._config.pld_enabled:
            from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=self._config.pld_params.get("theta", 1.0),
                gamma=self._config.pld_params.get("gamma", 0.001))

    def _curriculum_truncate(self, batch):
        """The seqlen curriculum (the JAX engine's ``train_batch``, reference
        ``engine.py:1691-1694``): each ``[gas, B, S, ...]`` leaf cut to the
        step's difficulty on dim 2, and a 4-D leaf square in its last two
        dims (``[gas, B, S, S]``, an attention mask) on dim 3 too; later
        dims stay whole, as in the JAX engine."""
        difficulty = self.curriculum_scheduler.update_difficulty(self._host_global_steps)
        seq = max((x.shape[2] for x in batch.values() if x.dim() >= 3), default=0)
        if difficulty >= seq:
            return batch

        def trunc(x):
            if x.dim() >= 3 and x.shape[2] == seq:
                x = x[:, :, :difficulty]
                if x.dim() == 4 and x.shape[3] == seq:
                    x = x[:, :, :, :difficulty]
                x = x.contiguous()
            return x
        return {k: trunc(x) for k, x in batch.items()}

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
        # under ZeRO sized by the whole leaves, so every rank's buffer (which
        # the sentinels' reduction sums) has one shape
        sizes = [math.prod(self._zero.shape(n)) for n in self._names] \
            if self._zero is not None else \
            [p.numel() for p in self._param_dict(self.state.params).values()]
        slots = max(self.tx.sq_slots(n) for n in sizes)
        return torch.zeros(len(self._names), slots, device=self.device), False

    # ------------------------------------------------------------------ #
    # state

    def _init_state(self, model_parameters) -> TrainState:
        if self._zero_mode:
            return self._init_zero_state(model_parameters)
        tree = model_parameters.to_dict() \
            if isinstance(model_parameters, (ParamTree, PartitionedParams)) else model_parameters
        dev = self.device
        params = ParamTree(map_tree(
            lambda a: torch.as_tensor(a).detach().to(dev, self.compute_dtype, copy=True), tree),
            requires_grad=True)
        self._names = [n for n, _ in params.named_parameters()]
        self._groups = list(jax_leaves(self._names).values())
        master = None
        if self._config.offload_optimizer_device in ("cpu", "nvme"):
            self._offload = self._build_offload(dict(ParamTree(tree).named_parameters()),
                                                self._param_dict(params))
        elif self.mixed_precision:
            fp32 = ParamTree(map_tree(
                lambda a: torch.as_tensor(a).detach().to(dev, torch.float32, copy=True), tree))
            master = {n: p.data for n, p in fp32.named_parameters()}
        target = master if master is not None else self._param_dict(params)
        opt_state = None
        if self.client_optimizer is not None:
            self.client_optimizer = self._bind_client_optimizer(self.client_optimizer, target)
        elif self._offload is None:
            opt_state = self.tx.init(target)
        state = TrainState(params=params, master=master, opt_state=opt_state, acc_grads=None,
                           scaler=self._make_scaler())
        self.state = state
        if self._uses_acc_grad_buffers():
            self._ensure_acc_grads()
        return state

    def _make_scaler(self) -> LossScaleState:
        if self.fp16_enabled() and self._config.fp16_config.dynamic_loss_scale:
            args = self._config.dynamic_loss_scale_args
            return make_loss_scale_state(init_scale=args["init_scale"],
                                         scale_window=args["scale_window"],
                                         min_scale=args["min_scale"],
                                         delayed_shift=args["delayed_shift"])
        if self.fp16_enabled():
            return make_loss_scale_state(init_scale=self._config.loss_scale or 1.0, dynamic=False)
        return make_loss_scale_state(init_scale=1.0, dynamic=False)

    def _init_zero_state(self, model_parameters) -> TrainState:
        """The partitioned state (``runtime/zero/state.py``) from a full
        tree or a ``PartitionedParams`` (``zero.Init``): this rank's masters
        and optimizer state (the optimizer built over its segments), its
        part of the accumulation buffer, the compute params of the stage."""
        group = self._zero_group
        world, rank = dist.get_world_size(group), dist.group_rank(group)
        if isinstance(model_parameters, PartitionedParams):
            given = model_parameters
            named_shapes = [(n, s) for u in given.units for n, s in zip(u.names, u.shapes)]
        else:
            tree = model_parameters.to_dict() if isinstance(model_parameters, ParamTree) \
                else model_parameters
            given = {n: p.detach() for n, p in ParamTree(tree).named_parameters()}
            named_shapes = [(n, tuple(t.shape)) for n, t in given.items()]
        self._names = [n for n, _ in named_shapes]
        self._groups = list(jax_leaves(self._names).values())
        self._name_index = {n: i for i, n in enumerate(self._names)}
        zero = ZeroState(self.zero_rules, build_units(named_shapes, world), self._names, group,
                         rank, world, self.device, self.compute_dtype, self.grad_acc_dtype,
                         self.mixed_precision)
        zero.build(given)
        del given
        self._zero = zero
        opt_state = None
        if self.client_optimizer is not None:
            self.client_optimizer = self._bind_client_optimizer(self.client_optimizer,
                                                                zero.targets)
        else:
            opt_state = self.tx.init(zero.targets)
        self.state = TrainState(params=zero.params,
                                master=zero.targets if self.mixed_precision else None,
                                opt_state=opt_state, acc_grads=None,
                                scaler=self._make_scaler())
        self._ensure_acc_grads()
        log_dist(f"ZeRO stage {zero.stage} over {group} ({world} ranks): "
                 f"{len(zero.units)} units, this rank holds {zero.held_bytes(opt_state)} bytes",
                 ranks=[0])
        return self.state

    @staticmethod
    def _param_dict(params: ParamTree) -> Dict[str, torch.Tensor]:
        return dict(params.named_parameters())

    def _build_offload(self, given: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]):
        """The host optimizer over the given values (its fp32 masters, by
        JAX leaf), and the pinned staging slabs of one update: fp32 grads
        and, for bf16 compute, the bf16 params (pinned on the card, at their
        exact size)."""
        from deepspeed_tpu_torch.ops.aio import HostSlab
        from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
        cfg = self._config
        groups = {".".join(path): names for path, names in jax_leaves(self._names).items()}
        off = HostOffloadOptimizer(
            {k: [given[n] for n in names] for k, names in groups.items()},
            optimizer_name=self._optimizer_name, optimizer_params=cfg.optimizer_params,
            device=cfg.offload_optimizer_device, nvme_path=cfg.offload_optimizer_nvme_path,
            grad_clip=float(self.gradient_clipping() or 0.0))
        pin = self.device.type == "cuda"
        total = sum(p.numel() for p in params.values())
        self._offload_groups = groups
        self._grad_slab = HostSlab(total * 4, pin)
        self._out_slab = HostSlab(total * 2, pin) if self.compute_dtype == torch.bfloat16 \
            else None
        self._offload_grads, self._offload_out = {}, {}
        off_b = 0
        for k, names in groups.items():
            n = sum(params[m].numel() for m in names)
            self._offload_grads[k] = self._grad_slab.bytes[4 * off_b:4 * (off_b + n)].view(
                torch.float32)
            if self._out_slab is not None:
                self._offload_out[k] = self._out_slab.bytes[2 * off_b:2 * (off_b + n)].view(
                    torch.bfloat16)
            off_b += n
        log_dist(f"ZeRO-Offload: optimizer on {off.device} ({len(off.order)} tensors, native "
                 f"cpu_{self._optimizer_name})", ranks=[0])
        return off

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
            given = [n for names in self._groups for n in names if n in targets]
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
        """Whether train_batch reads the accumulation buffers (gas > 1, the
        host optimizer's boundary, or a data-parallel group)."""
        return (self.gradient_accumulation_steps() != 1 or self._offload is not None
                or self._dp is not None)

    def _ensure_acc_grads(self) -> None:
        """Allocate the accumulation buffers (gas > 1, or the trio). With a
        data-parallel group they are views of one flat buffer laid out in
        the flat units of ``runtime/zero/partition.py``: whole at stages 0-1,
        averaged by one all-reduce at the boundary (stage 1 updates its
        block of each unit); the rank's blocks at stages 2-3, which each
        micro-step's gradients are reduce-scattered into."""
        if self.state.acc_grads is not None:
            return
        zero = self._zero
        named = list(self.state.params.named_parameters()) if zero is None else None
        if self._dp is None:
            self.state.acc_grads = {
                n: torch.zeros(p.shape, dtype=self.grad_acc_dtype, device=p.device)
                for n, p in named}
            return
        units = zero.units if zero is not None else \
            build_units([(n, tuple(p.shape)) for n, p in named], 1)
        blocks = zero is not None and zero.stage >= 2
        self._flat_grads, views = flat_buffer(units, self.grad_acc_dtype, self.device,
                                              zero.rank if blocks else None)
        if zero is not None:
            zero.bind_acc(self._flat_grads, views)
        self.state.acc_grads = zero.grads if blocks else {
            n: v for u, flat in zip(units, views) for n, v in zip(u.names, unit_leaves(u, flat))}

    def _average_grads(self) -> None:
        """The data-parallel mean of the accumulated gradients: one
        all-reduce (AVG) of the flat buffer in place; at stages 2-3 the
        reduce-scattered sums divided by the group's size."""
        if self._zero is not None and self._zero.stage >= 2:
            if self._zero.world > 1:
                self._flat_grads.div_(self._zero.world)
            return
        dist.all_reduce_in_place(self._flat_grads, op=dist.ReduceOp.AVG, group=self._dp)

    def load_train_state(self, params=None, master=None, opt_state=None,
                         global_steps: Optional[int] = None) -> None:
        """Carry a training state in (e.g. one taken from the JAX package
        with ``checkpoint.from_jax``): ``params`` a tree of the model's
        layout, ``master`` and the optimizer state's tensors by leaf name
        (an ``AdamState``, ``SGDState``, ``LionState`` or ``AdagradState``
        of the engine's optimizer). Values are copied into the engine's own
        tensors; what is not given stays. Under ZeRO-Offload the host
        masters take ``master`` (else ``params``); the host optimizer's
        state loads through a checkpoint's ``offload_state_p0.npz``."""
        if self._zero is not None:
            self._zero_load_train_state(params, master, opt_state)
            if global_steps is not None:
                self.state.global_steps = int(global_steps)
            return
        named = self._param_dict(self.state.params)
        if self._offload is not None:
            if opt_state is not None:
                raise TypeError("the host optimizer's state loads through load_checkpoint "
                                "(offload_state_p0.npz), not load_train_state")
            with torch.no_grad():
                if params is not None:
                    tree = params.to_dict() if isinstance(params, ParamTree) else params
                    src = dict(ParamTree(tree).named_parameters())
                    for n, p in named.items():
                        p.copy_(src[n])
                if master is not None:
                    for n, p in named.items():
                        p.copy_(master[n])
                if params is not None or master is not None:
                    self._offload.load_masters(self._offload_flat(
                        master if master is not None else src))
            if global_steps is not None:
                self.state.global_steps = int(global_steps)
            return
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

    def _zero_load_train_state(self, params, master, opt_state) -> None:
        """:meth:`load_train_state` under ZeRO: each rank writes its part of
        every given leaf (no collective)."""
        z = self._zero
        if params is not None:
            tree = params.to_dict() if isinstance(params, ParamTree) else params
            self._zero_load_params(dict(ParamTree(tree).named_parameters()),
                                   masters=master is None)
        if master is not None:
            for n in self._names:
                z.set_leaf("master", n, master[n])
                z.set_leaf("params", n, torch.as_tensor(master[n]).to(self.compute_dtype))
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
                    z.set_leaf(("opt", field), n, getattr(opt_state, field)[n], opt_state=mine)
            mine.count = int(opt_state.count)

    def _zero_load_params(self, src: Dict[str, torch.Tensor], masters: bool = True) -> None:
        """The leaves of ``src`` (by name) into the compute params and, with
        ``masters``, the fp32 masters, under ZeRO."""
        for n in self._names:
            if n in src:
                self._zero.set_leaf("params", n, src[n].detach())
                if masters and self.mixed_precision:
                    self._zero.set_leaf("master", n, src[n].detach().float())

    def zero_held_bytes(self) -> Dict[str, int]:
        """Bytes of state this rank holds outside a gather window, by kind
        (``params``, ``master``, ``optimizer``, ``grads``): under ZeRO its
        partition's; else the whole state's."""
        if self._zero is not None:
            return self._zero.held_bytes(self.state.opt_state)
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        st = self.state
        opt = sum(nbytes(getattr(st.opt_state, f).values())
                  for f in getattr(st.opt_state, "FIELDS", ()))
        return {"params": nbytes(st.params.parameters()),
                "master": nbytes(st.master.values()) if st.master is not None else 0,
                "optimizer": opt,
                "grads": nbytes(st.acc_grads.values()) if st.acc_grads is not None else 0}

    def gathered_params(self) -> ParamTree:
        """The compute params whole (gathered under ZeRO stage 3: a
        collective on every rank)."""
        params = self.state.params
        if isinstance(params, PartitionedParams):
            return ParamTree(params.to_dict())
        return params

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
        with gather_window(self.state.params):
            out = self.loss_fn(self.state.params, batch, self._rng)
        loss = out[0] if isinstance(out, tuple) else out
        (loss.float() * self.state.scaler.loss_scale).backward()
        return loss.detach()

    def _accumulate(self) -> None:
        """Add each leaf's ``.grad`` to its buffer and release it (at ZeRO
        stages 2-3, ``ZeroState.accumulate``: reduced into the partition)."""
        if self._zero is not None and self._zero.stage >= 2:
            self._zero.accumulate()
            return
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
        vector is gathered on the way (:class:`_Sentinels`).

        Under ZeRO (``self._zero``) only this rank's segments are unscaled
        and updated: the norm is the square root of the group's summed
        partial squares, the overflow flag the group's MAX, each LAMB
        group's ``Σp²`` and ``Σu²`` partials are summed over the group
        before its trust ratio, the sentinels' per-leaf sums reduced once;
        then one all-gather a unit refreshes the compute params. Over a
        group of one rank no collective changes a bit, so the step equals
        stage 0's."""
        st = self.state
        zero = self._zero
        many = zero is not None and zero.world > 1
        from_buffers = grads is None
        if from_buffers and self._dp is not None:
            self._average_grads()
        denom = st.scaler.loss_scale * gas
        if from_buffers:
            # fp32 buffers are unscaled in place (they are zeroed after)
            src = zero.grads if zero is not None else st.acc_grads
            grads = {n: (g.div_(denom) if g.dtype == torch.float32 else g.float() / denom)
                     for n, g in src.items()}
            unscaled = grads.__getitem__
        else:
            unscaled = lambda n: grads[n].float() / denom
        names = zero.names if zero is not None else self._names
        overflow = bool(has_overflow(unscaled(n) for n in names)) if self.fp16_enabled() \
            else False
        if self._dp is not None and self.fp16_enabled():
            # every rank skips together: the flag's MAX over the group
            flag = torch.tensor([float(overflow)], device=self.device)
            overflow = bool(dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._dp)[0])
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
        if many and norm is not None:
            sq = torch.square(norm.to(self.device, torch.float32)).reshape(1)
            norm = torch.sqrt(dist.all_reduce(sq, op=dist.ReduceOp.SUM,
                                              group=zero.group)[0])
        self._global_grad_norm = norm
        lr = float(self._lr_fn(st.global_steps))
        self._last_lr = lr
        params = self._param_dict(st.params) if zero is None else None
        targets = zero.targets if zero is not None else \
            (st.master if st.master is not None else params)
        refresh = st.master is not None and zero is None
        row = (lambda i, n: self._name_index[n]) if zero is not None else (lambda i, n: i)
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
                        if zero is not None:
                            group = [n for n in group if n in targets]
                        self.tx.group_update(st.opt_state, group, clipped, targets, lr,
                                             unorm=unorm,
                                             reduce=self._zero_reduce_partials if many else None,
                                             device=self.device)
                        for n in group:
                            if sen is not None:
                                sen.updated(targets[n], name=n)
                            if refresh:
                                params[n].copy_(targets[n])
                else:
                    st.opt_state.count += 1
                    for i, n in enumerate(names):
                        sq = (sen.upd[row(i, n), :self.tx.sq_slots(targets[n].numel())]
                              if sen is not None else None)
                        self.tx.leaf_update(st.opt_state, n, clipped(n), targets[n], lr, sq=sq)
                        if sen is not None:
                            sen.updated(targets[n], name=n)
                        if refresh:
                            params[n].copy_(targets[n])
                if zero is not None:
                    zero.refresh_params()
                if sen is not None:
                    sen.lr = lr
        elif sen is not None:
            for n in names:     # an fp16 skip: params read as they stand, update norm 0
                sen.updated(targets[n], name=n)
        if sen is not None:
            if many:
                sen.reduce(self._names, names, zero.group)
            self._sentinels = sen.vector(norm)
        st.scaler = scaler_update(st.scaler, overflow)
        if from_buffers:
            self._zero_acc_grads()
        st.global_steps += 1
        st.skipped_steps += int(overflow)

    def _zero_reduce_partials(self, partials: torch.Tensor) -> torch.Tensor:
        """A LAMB group's ``[k, 2]`` fp64 partials (``Σp²``, ``Σu²``) of this
        rank's segments -> the group's sums over every rank, ``[1, 2]``."""
        return dist.all_reduce(partials.sum(0, keepdim=True), op=dist.ReduceOp.SUM,
                               group=self._zero.group)

    def _client_step(self, clipped, targets, params, sen) -> None:
        """The client optimizer's update: every target's ``.grad`` set to its
        clipped fp32 gradient (all alive together), one ``step()``, the
        grads cleared, the compute params refreshed (under ZeRO by the
        caller). With sentinels on, a full copy of the targets is kept
        across the step for the update norm: a torch optimizer exposes no
        update vector."""
        order = self._client_names
        for n in order:
            targets[n].grad = clipped(n)
        old = [targets[n].clone() for n in order] if sen is not None else None
        self.client_optimizer.step()
        for i, n in enumerate(order):
            targets[n].grad = None
            if sen is not None:
                sen.updated(targets[n], old[i].sub_(targets[n]), name=n)
                old[i] = None
            if self.state.master is not None and self._zero is None:
                params[n].copy_(targets[n])

    def _host_step(self, gas: int) -> None:
        """The offload boundary (JAX ``_host_step``): the buffers to the
        host (:meth:`_offload_d2h`), the host optimizer's step
        (:meth:`_offload_update`), the updated params back in place
        (:meth:`_offload_h2d`), then the scaler, the counters and the lr
        scheduler. One sync a step: the host reads the grads."""
        st = self.state
        lr = float(self._lr_fn(st.global_steps))
        self._last_lr = lr
        self._offload_d2h()
        staged, overflow = self._offload_update(st.scaler.loss_scale * gas, lr)
        if not overflow:
            self._offload_h2d(staged)
        for g in st.acc_grads.values():
            g.zero_()
        st.scaler = scaler_update(st.scaler, overflow)
        st.global_steps += 1
        st.skipped_steps += int(overflow)
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()

    def _offload_d2h(self) -> None:
        """Every accumulation buffer into its slice of the pinned fp32 grad
        slab (copies queued on the stream), then the one sync."""
        acc = self.state.acc_grads
        with torch.no_grad():
            for key, names in self._offload_groups.items():
                for n, v in zip(names, self._offload.layer_views(key, self._offload_grads[key])):
                    v.copy_(acc[n], non_blocking=True)
        self._acc.synchronize()

    def _offload_update(self, denom: float, lr: float):
        """The host pass: unscale each key's grads in place, taking the grad
        norm (telemetry) and the non-finite count (health) on the way, as
        the JAX engine does; then the host optimizer's step, which writes
        the bf16 params into the out slab. Returns ``(staged, overflow)``."""
        from deepspeed_tpu_torch.runtime.zero.offload import nonfinite as nonfinite_grad
        grads = self._offload_grads
        sq, nonfinite = 0.0, 0.0
        for g in grads.values():
            g.div_(denom)
            if self._telemetry is not None:
                sq += float(torch.dot(g, g))
            if self._health is not None and nonfinite_grad(g):
                nonfinite += float(g.numel() - int(torch.isfinite(g).sum()))
        if self._telemetry is not None:
            self._global_grad_norm = torch.tensor(sq**0.5, device=self.device)
        self._offload_nonfinite = nonfinite if self._health is not None else None
        return self._offload.step(grads, lr, out=self._offload_out or None)

    def _offload_h2d(self, staged) -> None:
        """The staged params (bf16 from the out slab, else the fp32 masters)
        into the compute params in place, queued without a sync (the next
        boundary's sync orders them before the slab is rewritten)."""
        params = self._param_dict(self.state.params)
        with torch.no_grad():
            for key, names in self._offload_groups.items():
                for n, v in zip(names, self._offload.layer_views(key, staged[key])):
                    params[n].copy_(v, non_blocking=True)

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
        expected = gas * micro_bs * self.dp_world_size
        if batch is not None and self._batch_fn is not None:
            # the batch_fn normalizes the raw batch before any shape check
            batch = self._batch_fn(batch)
        if batch is not None:
            lead = next(iter(batch.values())).shape[0]
            if lead != expected:
                raise ValueError(
                    f"train_batch leading dim {lead} != gas({gas}) * micro_bs({micro_bs}) "
                    f"* dp({self.dp_world_size}) = {expected}")
            batch = self._batch_to_device({k: self._rank_block(x, gas) for k, x in batch.items()})
        else:
            micros = [next(self._standing_iterator(data_iter)) for _ in range(gas)]
            if self._batch_fn is not None:
                micros = [self._batch_fn(m) for m in micros]
            micros = [self._batch_to_device({k: self._rank_block(x, None) for k, x in m.items()})
                      for m in micros]
            batch = {k: torch.stack([m[k] for m in micros]) for k in micros[0]}
        self._host_global_steps += 1
        self._maybe_profile_flops(batch)
        if self.curriculum_scheduler is not None and self._curriculum_metric == "seqlen":
            batch = self._curriculum_truncate(batch)
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
            self._quantize_step(batch)
        self._write_monitor_events(loss)
        self._report_progress(loss)
        return loss

    def _maybe_profile_flops(self, batch) -> None:
        """The flops profiler (reference engine.py:1664,2060; JAX
        ``runtime/engine.py:997-1009``): at ``flops_profiler.profile_step``,
        one profile of the loss on the batch's first micro-batch, printed
        (or written to ``output_file``) and kept as ``self.flops_profiler``.
        The loss runs with ``rng=None`` (dropout off), so the engine's
        generator does not move."""
        fp_cfg = self._config.flops_profiler_config
        if not (fp_cfg.enabled and self._host_global_steps == fp_cfg.profile_step):
            return
        from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
        prof = FlopsProfiler(model=self.module, ds_engine=self,
                             recompute_fwd_factor=fp_cfg.recompute_fwd_factor)
        micro = {k: x[0][:self.train_micro_batch_size_per_gpu()] for k, x in batch.items()}
        prof.profile_fn(lambda p, b: self.loss_fn(p, b, None), self.state.params, micro)
        prof.print_model_profile(profile_step=self._host_global_steps,
                                 output_file=fp_cfg.output_file)
        self.flops_profiler = prof

    def _train_batch_body(self, batch, gas: int) -> torch.Tensor:
        """gas micro-steps and the update; returns the mean loss."""
        if gas == 1 and not self._uses_acc_grad_buffers():
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
            if self._offload is not None:
                self._host_step(gas)
            else:
                self._apply_update(gas)
            loss = torch.stack(losses).mean()
        if self._dp is not None:
            # the global batch's mean, as the JAX engine reports it
            loss = dist.all_reduce(loss, op=dist.ReduceOp.AVG, group=self._dp)
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

    def _quantize_step(self, batch) -> None:
        """MoQ after the update (the JAX engine's ``_quantize_step``, run by
        ``train_batch`` only): walk the per-leaf bit schedule and
        fake-quantize the compute-dtype params in place, never the fp32
        masters. An fp16 overflow step skipped its update and does not
        advance the schedule. With eigenvalue enabled, per-block curvature is
        re-estimated at gas boundaries while a precision switch is pending,
        on the batch's first micro-batch, and the MEAN across blocks scales
        the stacked-layers leaves' periods (the JAX engine's deviation from
        the reference's per-block factor, forced by the stacked-layers leaf
        layout; max is useless here because post_process normalizes the
        largest eigenvalue to 1.0). The HVPs run the model on plain attention
        and the plain CE head (``runtime/eigenvalue.hvp_model``)."""
        overflow = False
        if self.fp16_enabled():
            cur = self.state.skipped_steps
            overflow = cur > self._moq_seen_skipped
            self._moq_seen_skipped = cur
        named = self._param_dict(self.state.params)
        block_ev = None
        # the JAX engine's host step count: train_batch calls, this one included
        if self.eigenvalue is not None and \
                self._data_progress["iterations"] % self.eigenvalue.gas_boundary_resolution == 0 \
                and self.quantizer.any_precision_switch():
            micro = {k: x[0] for k, x in batch.items()}
            params = self.state.params
            name = self._ev_layer_name
            n_blocks = self._ev_layer_num or 0
            if n_blocks > 0 and params.get(name) is not None:
                masks = self.eigenvalue.layer_masks(params, name, n_blocks)
            else:
                masks = [dict.fromkeys(named, 1.0)]
            # the JAX engine splits its key: one seed for the start vectors
            # and the loss's dropout (the same mask in every HVP)
            seed = int(torch.randint(0, 2**62, (1,), generator=self._rng))
            loss_fn = _loss_fn_of(hvp_model(self.client_model))

            def scalar_loss(p):
                out = loss_fn(p, micro, torch.Generator().manual_seed(seed))
                return out[0] if isinstance(out, tuple) else out

            vals = self.eigenvalue.compute_eigenvalue(
                scalar_loss, params, masks,
                generator=torch.Generator(device=self.device).manual_seed(seed))
            block_ev = {name: sum(vals) / len(vals)} if vals else None
        self.quantizer.quantize_tree(named, overflow=overflow, block_eigenvalue=block_ev)

    def forward(self, batch):
        """Loss of one micro-batch, with its graph kept for ``backward``."""
        self.timers(SynchronizedWallClockTimer.FORWARD_GLOBAL_TIMER).start()
        t0 = time.perf_counter()
        with gather_window(self.state.params):
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
        if self._offload is not None:      # steps the lr scheduler itself
            self._host_step(self.gradient_accumulation_steps())
        else:
            self._apply_update(self.gradient_accumulation_steps())
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        self._tel_phase("step", t0)
        self.timers(SynchronizedWallClockTimer.STEP_GLOBAL_TIMER).stop()
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
        with torch.no_grad(), gather_window(self.state.params):
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
        elif self._offload is not None:   # the host pass's count (JAX offload path)
            rec.nonfinite_grads = self._offload_nonfinite
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
        if self._dp is None:
            return save_engine_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                          save_latest=save_latest, asynchronous=asynchronous)
        # with a process group rank 0 writes, then every rank meets at a
        # barrier, as the JAX writer does; under ZeRO every rank takes part
        # in the snapshot's gathers of the partitioned state (the files are
        # the same: full params, masters and optimizer state)
        ok = True
        if dist.get_rank() == 0 or self._zero is not None:
            ok = save_engine_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                        save_latest=save_latest, asynchronous=asynchronous,
                                        write=dist.get_rank() == 0)
        dist.barrier()
        return ok

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False, strict=False,
                        load_data_progress=False):
        """Load a tag (default: the newest intact one under ``load_dir``),
        all or nothing. Returns ``(path, client_state)``, ``(None, {})``
        when there is nothing to load (unless ``strict``)."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import load_engine_checkpoint
        result = load_engine_checkpoint(self, load_dir, tag=tag,
                                        load_optimizer_states=load_optimizer_states,
                                        load_module_only=load_module_only, strict=strict,
                                        load_data_progress=load_data_progress)
        # the host step counter (the curriculum's clock) follows the restored step
        self._host_global_steps = int(self.global_steps)
        return result

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
        stored as raw bits under ``key::bf16``). Returns the path. With a
        process group every rank calls it (under ZeRO each leaf is a
        gather), rank 0 writes, and the ranks meet at a barrier."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _nest
        from deepspeed_tpu_torch.utils.pytree import leaf_paths

        if exclude_frozen_parameters:
            raise NotImplementedError(
                "exclude_frozen_parameters: the functional engine has no "
                "frozen-parameter registry; filter the tree before saving")
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        if self._zero is not None:
            from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _zero_nest
            self._zero.clear_cache()
            tree = _zero_nest(self, jax_leaves(self._names), "params", self.compute_dtype)
        else:
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
        if self._dp is None or dist.get_rank() == 0:
            np.savez(path, **flat)
        if self._dp is not None:
            dist.barrier()
        log_dist(f"saved 16-bit model weights to {path}", ranks=[0])
        return path

    def save_fp16_model(self, save_dir, save_filename: str = "model_16bit.npz"):
        """Alias of save_16bit_model."""
        return self.save_16bit_model(save_dir, save_filename)

    # ------------------------------------------------------------------ #
    # the rest of the engine surface

    def _zero_acc_grads(self) -> None:
        if self._flat_grads is not None:
            self._flat_grads.zero_()
        elif self.state.acc_grads is not None:
            for g in self.state.acc_grads.values():
                g.zero_()

    def zero_grad(self) -> None:
        """Zero the gradient-accumulation buffers and drop a pending
        forward's graph (between trio steps)."""
        self._zero_acc_grads()
        for p in self.state.params.parameters():
            p.grad = None
        self._cached_loss = None

    def set_train_batch_size(self, train_batch_size: int) -> None:
        """Change the global batch through the gradient-accumulation steps;
        the micro-batch size stays."""
        micro = self.train_micro_batch_size_per_gpu()
        dp = self.dp_world_size
        if train_batch_size % (micro * dp):
            raise ValueError(
                f"Train batch size ({train_batch_size}) must be divisible by "
                f"micro-batch ({micro}) x data parallelism ({dp})")
        new_gas = train_batch_size // (micro * dp)
        if new_gas < 1:
            raise ValueError(f"Train batch size ({train_batch_size}) must cover "
                             f"at least one micro-batch per dp rank ({micro * dp})")
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
        if self._zero is not None:
            if strict and (set(src) != set(self._names) or any(
                    tuple(src[n].shape) != self._zero.shape(n) for n in self._names)):
                raise ValueError("state_dict structure does not match module parameters (pass "
                                 "strict=False to overlay matching leaves only)")
            self._zero_load_params(src)
            return
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
        if self._offload is not None:
            # the host masters are the next step's weights: refresh them or
            # the load is silently reverted
            self._offload.load_masters(self._offload_flat(named))

    def _offload_flat(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``named`` tensors as flat fp32 host arrays by JAX leaf."""
        return {k: torch.cat([named[n].detach().float().reshape(-1).cpu() for n in names])
                for k, names in self._offload_groups.items()}

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

    def pld_enabled(self) -> bool:
        return bool(self._config.pld_enabled)

    def curriculum_enabled_legacy(self) -> bool:
        return bool(self._config.curriculum_enabled_legacy)

    def random_ltd_enabled(self) -> bool:
        return bool(self._config.data_efficiency_config["data_routing"]["random_ltd"]
                    .get("enabled", False))

    def get_pld_theta(self):
        """Current progressive-layer-drop theta, or None when PLD is off
        (reference ``engine.py:2180``)."""
        if self.progressive_layer_drop is not None:
            return self.progressive_layer_drop.get_theta()
        return None

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
