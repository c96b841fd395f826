"""Master training config (counterpart of ``deepspeed_tpu/config/core.py``).

``DeepSpeedConfig`` parses the framework's JSON config (a dict or a path)
for the subset that training on one device reads: the batch-size triad
``train_batch = micro_batch x gradient_accumulation_steps x world_size``,
resolved and validated as the JAX package does (reference
``runtime/config.py:853-907``); the optimizer and scheduler names and
params; ``gradient_clipping``; fp16 / bf16 / amp; the gradient accumulation
dtype; ``fused_cross_entropy``; ``quantize_training`` (MoQ, read as the
JAX package reads it: on only with ``enabled: true``; its ``eigenvalue``
schedule too); ``compression_training`` (parsed into
``compression_config``, which the user's ``compression.init_compression``
applies, not the engine); the ``checkpoint``
section (:class:`CheckpointConfig`, the crash-safe engine's knobs) and
``dataloader_drop_last``; ``steps_per_print`` and ``wall_clock_breakdown``;
``telemetry`` (``monitor/config.py``: the engine refuses its unported
sub-blocks) and the ``tensorboard`` / ``wandb`` / ``csv_monitor`` sinks;
``flops_profiler`` (the engine profiles the loss at its ``profile_step``),
``elasticity`` and ``autotuning``, parsed as the JAX config parses them.

``world_size`` is the data-parallel world: the ranks of the mesh's ``dp``
and ``fsdp`` axes (``mesh``, default ``{"dp": -1}``); every other axis must
be 1, and ``comms_logger`` configures ``comm``'s logger.
``zero_optimization`` is parsed into ``zero_config``
(``runtime/zero/config.py``). ZeRO stages 0-3 are accepted at every world
size: with a process group the engine partitions the masters and the
optimizer state (stage 1), the gradients (stage 2) and the compute params
(stage 3) over the data-parallel axes; without one every stage replicates
everything, as the JAX sharding rules do over a mesh of one device.
ZeRO-Offload runs on one rank only.
``zero_optimization.offload_optimizer`` ``cpu`` or
``nvme`` (with ``nvme_path``) puts the optimizer on the host
(``runtime/zero/offload.py``); ``offload_param`` is read and, as in the JAX
training engine, has no effect on one device. Sections that change the result or the schedule and are
not ported raise ``NotImplementedError`` naming their ROADMAP.md item; keys
the JAX package reads that have no effect on one device are accepted; any
other key raises, so a misspelt option is never silently dropped.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.config.precision import AMPConfig, BF16Config, FP16Config
from deepspeed_tpu_torch.monitor.config import get_monitor_config, get_telemetry_config
from deepspeed_tpu_torch.utils.not_ported import not_ported


class DeepSpeedConfigError(Exception):
    pass


@dataclasses.dataclass
class CheckpointConfig:
    """The ``"checkpoint"`` section's fault-tolerance knobs (the JAX
    package's ``CheckpointConfig``, same names and defaults)."""
    # storage engine: "safe" = the crash-safe two-phase npz + manifest
    # format; "orbax" (multi-host sharded writes) is refused by name
    engine: str = "safe"
    # two-phase async save: snapshot on the training thread, persist on the
    # background writer. Off by default so save_checkpoint() returning
    # means "durably on disk" unless opted in.
    async_save: bool = False
    # bounded writer queue: snapshots held in host memory at once
    max_pending: int = 2
    # retention: keep this many newest tags (0 = keep all). The newest
    # VERIFIED tag and the `latest` target are never GC'd.
    keep_last: int = 0
    # transient I/O error retry budget (exponential backoff)
    retries: int = 3
    retry_backoff_s: float = 0.5
    # verify the blake2b manifest before any load touches engine state
    verify_on_load: bool = True
    # SIGTERM/SIGINT grace handling: drain the writer, emergency-save to
    # save_dir, exit 128+signum. Requires save_dir.
    preemption_save: bool = False
    save_dir: Optional[str] = None


_TAG_VALIDATION_MODES = ("Warn", "Ignore", "Fail")


ADAGRAD_OPTIMIZER = "adagrad"
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
FUSED_ADAM_OPTIMIZER = "fusedadam"
FUSED_LAMB_OPTIMIZER = "fusedlamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
DEEPSPEED_OPTIMIZERS = [
    ADAGRAD_OPTIMIZER, ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, LION_OPTIMIZER, SGD_OPTIMIZER
]

# keys read below
_READ = {
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.GRADIENT_ACCUMULATION_STEPS,
    C.STEPS_PER_PRINT, C.WALL_CLOCK_BREAKDOWN, C.OPTIMIZER, C.SCHEDULER, C.GRADIENT_CLIPPING,
    C.FP16, C.BFLOAT16, C.BFLOAT16_OLD, C.AMP, C.DATA_TYPES, C.ZERO_OPTIMIZATION,
    C.FUSED_CROSS_ENTROPY, C.SPARSE_ATTENTION, "mesh", "quantize_training", "checkpoint",
    "dataloader_drop_last", "telemetry", "tensorboard", "wandb", "csv_monitor",
    "compression_training", "activation_checkpointing", "curriculum_learning",
    "data_efficiency", "progressive_layer_drop", "flops_profiler", "elasticity", "autotuning",
    "comms_logger",
}
# keys the JAX package reads whose effect is on multi-device runs or on
# engine features outside training itself; on one device they change nothing
_NO_EFFECT_ON_ONE_DEVICE = {
    "dump_state", "disable_allgather", "communication_data_type", "prescale_gradients",
    "gradient_predivide_factor", "sparse_gradients", "memory_breakdown",
    "zero_allow_untested_optimizer",
}
# DeepSpeed sections the JAX config accepts without effect on training: it
# has no comet sink, and it parses and stores weight_quantization (the
# inference-side int8 settings, which no training path reads)
_IGNORED = {"comet", "weight_quantization"}
# sections that are not ported: key -> (what, ROADMAP.md item)
_NOT_PORTED = {
    "pipeline": ("pipeline parallelism", "runtime/pipe/"),
    "nebula": ("nebula checkpointing", "checkpoint ingestion (orbax)"),
}
_ONEBIT = (ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER)
# the mesh axes training does not split the batch over, by ROADMAP.md item
_AXIS_ITEMS = {"pp": "runtime/pipe/", "sp": "sequence/", "ep": "MoE with ep > 1"}
_DATA_AXES = ("dp", "fsdp")
_OFFLOAD_DEVICES = ("none", "null", "cpu", "nvme")


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys when parsing a JSON config (reference behavior)."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        seen, dup = set(), []
        for k, _ in ordered_pairs:
            if k in seen:
                dup.append(k)
            seen.add(k)
        raise ValueError(f"Duplicate keys in DeepSpeed config: {dup}")
    return d


def _enabled(section) -> bool:
    """Whether a config section asks for its feature: a dict with
    ``enabled`` false (or empty) asks for nothing."""
    if isinstance(section, dict):
        return bool(section) and section.get("enabled", True) is not False
    return bool(section)


def _refuse_outside_slice(param_dict: Dict, client_optimizer: bool = False,
                          world_size: int = 1) -> None:
    for key, value in param_dict.items():
        if key in _NOT_PORTED:
            if _enabled(value):
                what, item = _NOT_PORTED[key]
                not_ported(what, f"queue 1: {item}")
        elif key not in _READ and key not in _NO_EFFECT_ON_ONE_DEVICE and key not in _IGNORED:
            raise DeepSpeedConfigError(f"unknown config key {key!r}")
    zero = param_dict.get(C.ZERO_OPTIMIZATION, {})
    if isinstance(zero, dict):
        dev = (zero.get("offload_optimizer") or {}).get("device", "none")
        if client_optimizer and str(dev).lower() not in ("none", "null"):
            # the JAX engine's check
            raise ValueError("offload_optimizer is incompatible with a client optax optimizer; "
                             "configure the optimizer via the config instead")
        for off in ("offload_optimizer", "offload_param"):
            dev = str((zero.get(off) or {}).get("device", "none")).lower()
            if dev not in _OFFLOAD_DEVICES:
                raise DeepSpeedConfigError(
                    f"zero_optimization.{off}.device={dev!r} (expected none|cpu|nvme)")
    # data parallelism over the dp and fsdp axes (ZeRO stages 0-3) is
    # ported; every other axis spanning more than one rank is not
    mesh = param_dict.get("mesh") or {}
    for ax, n in mesh.items():
        if ax not in _DATA_AXES and (int(n) not in (1, -1) or (int(n) == -1 and world_size > 1)):
            not_ported(f"a multi-device mesh {mesh}",
                       f"queue 1: {_AXIS_ITEMS.get(ax, 'tensor-parallel training')}")
    if world_size > 1:
        zero = param_dict.get(C.ZERO_OPTIMIZATION, {})
        zero = {C.ZERO_STAGE: int(zero)} if isinstance(zero, bool) else zero
        off = zero.get("offload_optimizer") or ({"device": "cpu"} if zero.get("cpu_offload")
                                                else {})
        if str(off.get("device", "none")).lower() not in ("none", "null"):
            not_ported(f"ZeRO-Offload over {world_size} ranks", "queue 1: ZeRO-Offload over dp")
    opt = (param_dict.get(C.OPTIMIZER) or {}).get(C.TYPE)
    if opt is not None and str(opt).lower() in _ONEBIT:
        not_ported(f"the 1-bit optimizer {opt}", "queue 1: runtime/fp16/onebit/")
    ckpt = param_dict.get("checkpoint") or {}
    if str(ckpt.get("engine", "safe")).lower() == "orbax":
        not_ported("the orbax checkpoint engine (checkpoint.engine='orbax')",
                   "queue 1: checkpoint ingestion (orbax)")


class DeepSpeedConfig:
    """Parses + validates the training config (a dict or a path to JSON)."""

    def __init__(self, config: Union[str, Dict], world_size: int = 1,
                 client_optimizer: bool = False):
        if isinstance(config, dict):
            self._param_dict = copy.deepcopy(config)
        elif isinstance(config, str) and os.path.exists(config):
            with open(config) as f:
                self._param_dict = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path to an existing config file, or a dict. Received: {config}")
        # the data-parallel world (the mesh's dp axis; the other axes are 1)
        self.world_size = int(world_size)
        _refuse_outside_slice(self._param_dict, client_optimizer, self.world_size)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()
        from deepspeed_tpu_torch.runtime.zero.config import get_zero_config
        self.zero_config = get_zero_config(self._param_dict)

    def _initialize_params(self, param_dict: Dict) -> None:
        self.train_batch_size = param_dict.get(C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = param_dict.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = param_dict.get(
            C.GRADIENT_ACCUMULATION_STEPS, C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = param_dict.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = param_dict.get(C.WALL_CLOCK_BREAKDOWN,
                                                   C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.monitor_config = get_monitor_config(param_dict)
        from deepspeed_tpu_torch.comm.config import DeepSpeedCommsConfig
        self.comms_config = DeepSpeedCommsConfig(param_dict)
        # the mesh's named axes: {"dp": -1} puts every rank on dp
        self.mesh_axes: Dict[str, int] = dict(param_dict.get(C.MESH) or C.MESH_AXES_DEFAULT)
        self.telemetry_config = get_telemetry_config(param_dict)

        zero = param_dict.get(C.ZERO_OPTIMIZATION, {})
        if isinstance(zero, bool):        # the reference's deprecated boolean form
            zero = {C.ZERO_STAGE: int(zero)}
        self.zero_optimization_stage = int(zero.get(C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT))
        self.zero_enabled = self.zero_optimization_stage > 0
        # ZeRO-Offload (the JAX runtime/zero/config.py sections): the
        # optimizer's state on the host or NVMe; offload_param is read and
        # has no effect on one device, as in the JAX training engine
        off = zero.get("offload_optimizer") or (
            {"device": "cpu"} if zero.get("cpu_offload") else {})
        dev = str(off.get("device", "none")).lower()
        self.offload_optimizer_device = "none" if dev == "null" else dev
        self.offload_optimizer_nvme_path = off.get("nvme_path")
        off = zero.get("offload_param") or (
            {"device": "cpu"} if zero.get("cpu_offload_param") else {})
        dev = str(off.get("device", "none")).lower()
        self.offload_param_device = "none" if dev == "null" else dev

        self.fp16_config = FP16Config(**param_dict.get(C.FP16, {}))
        self.fp16_enabled = self.fp16_config.enabled
        self.bf16_config = BF16Config(**param_dict.get(C.BFLOAT16, param_dict.get(C.BFLOAT16_OLD, {})))
        self.bfloat16_enabled = self.bf16_config.enabled
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("bf16 and fp16 modes cannot be simultaneously enabled")
        self.amp_config = AMPConfig(**param_dict.get(C.AMP, {}))
        self.amp_enabled = self.amp_config.enabled
        self.loss_scale = self.fp16_config.loss_scale
        self.dynamic_loss_scale_args = dict(
            init_scale=2**self.fp16_config.initial_scale_power,
            scale_window=self.fp16_config.loss_scale_window,
            min_scale=self.fp16_config.min_loss_scale,
            delayed_shift=self.fp16_config.hysteresis,
        ) if self.fp16_config.dynamic_loss_scale else None

        self.gradient_clipping = param_dict.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        opt = param_dict.get(C.OPTIMIZER) or {}
        self.optimizer_name: Optional[str] = opt.get(C.TYPE, C.OPTIMIZER_TYPE_DEFAULT)
        if self.optimizer_name is not None and self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params: Optional[Dict[str, Any]] = (
            opt.get(C.OPTIMIZER_PARAMS) if self.optimizer_name is not None else None)
        sched = param_dict.get(C.SCHEDULER) or {}
        self.scheduler_name: Optional[str] = sched.get(C.TYPE, C.SCHEDULER_TYPE_DEFAULT)
        self.scheduler_params: Optional[Dict[str, Any]] = (
            sched.get(C.SCHEDULER_PARAMS) if self.scheduler_name is not None else None)

        self.gradient_accumulation_dtype = (param_dict.get(C.DATA_TYPES) or {}).get(
            C.GRAD_ACCUM_DTYPE, C.GRAD_ACCUM_DTYPE_DEFAULT)
        if self.gradient_accumulation_dtype not in (None, "fp32", "fp16", "bf16"):
            raise DeepSpeedConfigError(
                f"data_types.grad_accum_dtype={self.gradient_accumulation_dtype!r} "
                "(expected 'fp32', 'fp16' or 'bf16')")

        # stored as the JAX config stores it (config/core.py:284-285); read by nothing
        from deepspeed_tpu_torch.inference.config import WeightQuantConfig
        self.weight_quantization_config = (
            WeightQuantConfig(**param_dict["weight_quantization"])
            if "weight_quantization" in param_dict else None)

        # MoQ: progressive quantization-aware training (runtime/quantize.py)
        qt = param_dict.get("quantize_training", {})
        self.quantize_training_enabled = bool(qt.get("enabled", False))
        self.quantize_training = qt if self.quantize_training_enabled else {}

        # compression (compression/config.py), parsed as the JAX config
        # parses it; the engine does not apply it: the user wraps the model
        # with compression.init_compression
        from deepspeed_tpu_torch.compression.config import get_compression_config
        self.compression_config = get_compression_config(param_dict)

        # progressive layer drop and the legacy curriculum section, read as
        # the JAX config reads them (config/core.py:228-233); the engine
        # builds the curriculum from the legacy section or data_efficiency
        pld = param_dict.get("progressive_layer_drop", {})
        self.pld_enabled = pld.get("enabled", False)
        self.pld_params = pld if self.pld_enabled else False
        self.curriculum_enabled_legacy = param_dict.get("curriculum_learning", {}).get(
            "enabled", False)
        self.curriculum_params_legacy = param_dict.get("curriculum_learning", False)
        from deepspeed_tpu_torch.runtime.data_pipeline.config import get_data_efficiency_config
        self.data_efficiency_config = get_data_efficiency_config(param_dict)
        self.data_efficiency_enabled = self.data_efficiency_config.get("enabled", False)
        # recorded for runtime/activation_checkpointing's configure(); on
        # one device only cpu_checkpointing has an effect there
        from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
            DeepSpeedActivationCheckpointingConfig)
        self.activation_checkpointing_config = DeepSpeedActivationCheckpointingConfig(
            **param_dict.get("activation_checkpointing", {}))

        # the sparse attention section, kept as the JAX package keeps it: the
        # model's sparsity config (ops/sparse_attention) decides, nothing reads it
        self.sparse_attention = param_dict.get(C.SPARSE_ATTENTION, None)

        # the one-card tooling, read as the JAX config reads it
        # (JAX config/core.py:268-305): the engine profiles the loss at
        # flops_profiler.profile_step; the elastic plan and the autotuner
        # read their sections (elasticity/, autotuning/)
        from deepspeed_tpu_torch.profiling.config import DeepSpeedFlopsProfilerConfig
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig(
            **param_dict.get("flops_profiler", {}))
        from deepspeed_tpu_torch.elasticity.config import ElasticityConfig
        self.elasticity_enabled = param_dict.get(C.ELASTICITY, {}).get(C.ENABLED,
                                                                       C.ENABLED_DEFAULT)
        self.elasticity_config = (ElasticityConfig(param_dict.get(C.ELASTICITY, {}))
                                  if self.elasticity_enabled else None)
        from deepspeed_tpu_torch.autotuning.config import AutotuningConfig
        self.autotuning_config = AutotuningConfig(**param_dict.get("autotuning", {}))

        self._initialize_checkpoint_params(param_dict)
        self.dataloader_drop_last = bool(param_dict.get("dataloader_drop_last", False))

        self.fused_cross_entropy = param_dict.get(C.FUSED_CROSS_ENTROPY,
                                                  C.FUSED_CROSS_ENTROPY_DEFAULT)
        if self.fused_cross_entropy not in (None, "auto", "on", "off"):
            raise DeepSpeedConfigError(
                f"fused_cross_entropy={self.fused_cross_entropy!r} "
                "(expected 'auto', 'on' or 'off')")

    def _initialize_checkpoint_params(self, param_dict: Dict) -> None:
        """The ``checkpoint`` section, read as the JAX package reads it."""
        ckpt = dict(param_dict.get("checkpoint") or {})
        # the reference's keys beside the knobs: tags are validated across
        # processes and node-local storage spreads them (no effect on one
        # device); load_universal is read as the JAX package reads it (its
        # engine does not act on it either: the offline tools in checkpoint/
        # convert a universal checkpoint)
        mode = str(ckpt.pop("tag_validation", "Warn")).title()
        if mode not in _TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError(
                f"Checkpoint config contains invalid tag_validation value: {mode}")
        ckpt.pop("use_node_local_storage", None)
        self.load_universal_checkpoint = ckpt.pop("load_universal", False)
        known = {f.name for f in dataclasses.fields(CheckpointConfig)}
        unknown = sorted(set(ckpt) - known)
        if unknown:
            raise DeepSpeedConfigError(f"unknown checkpoint config keys {unknown}")
        self.checkpoint_config = CheckpointConfig(**ckpt)
        if self.checkpoint_config.engine != "safe":
            raise DeepSpeedConfigError(
                f"checkpoint.engine={self.checkpoint_config.engine!r} "
                "(expected 'safe' or 'orbax')")
        if self.checkpoint_config.preemption_save and not self.checkpoint_config.save_dir:
            raise DeepSpeedConfigError(
                "checkpoint.preemption_save requires checkpoint.save_dir")

    # ------------------------------------------------------------------ #
    # Batch triad (reference runtime/config.py:853-907)

    def _batch_assertion(self) -> None:
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if not train_batch > 0:
            raise DeepSpeedConfigError(f"Train batch size: {train_batch} has to be greater than 0")
        if not micro_batch > 0:
            raise DeepSpeedConfigError(
                f"Micro batch size per gpu: {micro_batch} has to be greater than 0")
        if not grad_acc > 0:
            raise DeepSpeedConfigError(
                f"Gradient accumulation steps: {grad_acc} has to be greater than 0")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not equal "
                f"to micro_batch_per_gpu * gradient_acc_step * world_size "
                f"{train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _set_batch_related_parameters(self) -> None:
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            return
        if train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError("Either train_batch_size or train_micro_batch_size_per_gpu "
                                       "needs to be provided")

    def _configure_train_batch_size(self) -> None:
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _do_sanity_check(self) -> None:
        if self.zero_optimization_stage > 3:
            raise DeepSpeedConfigError(
                f"Max supported ZeRO stage is 3, got {self.zero_optimization_stage}")
        if self.fp16_config.fp16_master_weights_and_grads and self.zero_optimization_stage not in (1, 2):
            raise DeepSpeedConfigError(
                "Fp16_master_weights_and_grads is only supported with ZeRO Stage 1/2 for now.")
