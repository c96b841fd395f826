"""The ``"zero_optimization"`` section (counterpart of
``deepspeed_tpu/runtime/zero/config.py``): the same fields, defaults,
``stage3_*`` aliases and deprecated forms, on the port's dataclass
:class:`~deepspeed_tpu_torch.config.config_utils.ConfigModel` (no pydantic).
Keys the JAX model does not name are kept out with a warning, as its
``extra="allow"`` accepts them.

What the port's engine does with each stage over its data-parallel ranks
(``runtime/zero/partition.py`` has the layout):

- stage 0: everything replicated; one all-reduce of the gradients;
- stage 1: the fp32 masters and the optimizer state partitioned;
- stage 2: + the gradient accumulation buffer partitioned (reduce-scatter);
- stage 3: + the compute params partitioned, each unit gathered just
  before its use and freed after; units smaller than
  ``param_persistence_threshold`` elements stay whole.

Which knobs the engine acts on: ``stage``, ``partition_axis``,
``param_persistence_threshold`` and the offload sections. The bucket and
overlap knobs (``reduce_bucket_size``, ``allgather_bucket_size``,
``overlap_comm``, ``prefetch_bucket_size``, ``max_live_parameters``,
``max_reuse_distance``, ``sub_group_size``, ``contiguous_gradients``,
``reduce_scatter``, ``round_robin_gradients``) are read and have no effect:
the engine issues one collective per unit (a layer, the embedding, the final
norm with the head), as the JAX package leaves bucketing and overlap to
XLA's scheduler.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepspeed_tpu_torch.config.config_utils import ConfigModel, alias
from deepspeed_tpu_torch.utils.logging import logger

ZERO_OPTIMIZATION = "zero_optimization"


def read_zero_config_deprecated(param_dict: dict) -> dict:
    """Support the ancient ``"zero_optimization": true`` boolean form."""
    zero_config_dict = {}
    zero_config_dict["stage"] = 1 if param_dict[ZERO_OPTIMIZATION] else 0
    if zero_config_dict["stage"] > 0:
        zero_config_dict["allgather_bucket_size"] = param_dict.get("allgather_size", 5e8)
    return zero_config_dict


def get_zero_config(param_dict: dict) -> "ZeroConfig":
    zero_config_dict = param_dict.get(ZERO_OPTIMIZATION, {})
    if isinstance(zero_config_dict, bool):
        zero_config_dict = read_zero_config_deprecated(param_dict)
    return ZeroConfig(**zero_config_dict)


OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _device(value) -> str:
    dev = "none" if value is None else str(value).lower()
    dev = "none" if dev == "null" else dev
    if dev not in OFFLOAD_DEVICES:
        raise ValueError(f"offload device {value!r} (expected none|cpu|nvme)")
    return dev


@dataclasses.dataclass(init=False)
class DeepSpeedZeroOffloadParamConfig(ConfigModel):
    """Where/how to offload partitioned parameters (ZeRO-3)."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False

    def __init__(self, **data):
        super().__init__(**data)
        self.device = _device(self.device)


@dataclasses.dataclass(init=False)
class DeepSpeedZeroOffloadOptimizerConfig(ConfigModel):
    """Where/how to offload optimizer states + computation."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False

    def __init__(self, **data):
        super().__init__(**data)
        self.device = _device(self.device)

    @property
    def pipeline(self) -> bool:
        return self.pipeline_read or self.pipeline_write


@dataclasses.dataclass(init=False)
class ZeroConfig(ConfigModel):
    """The ``"zero_optimization"`` section of the config JSON."""

    stage: int = 0

    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True

    elastic_checkpoint: bool = False

    # offload
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = dataclasses.field(
        default=None, metadata={"config": DeepSpeedZeroOffloadParamConfig})
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = dataclasses.field(
        default=None, metadata={"config": DeepSpeedZeroOffloadOptimizerConfig})

    # stage-3 specific
    sub_group_size: int = int(1e9)
    cpu_offload_param: Optional[bool] = dataclasses.field(
        default=None, metadata={"deprecated": True})
    cpu_offload_use_pin_memory: Optional[bool] = dataclasses.field(
        default=None, metadata={"deprecated": True})
    cpu_offload: Optional[bool] = dataclasses.field(default=None, metadata={"deprecated": True})

    prefetch_bucket_size: int = alias(int(5e7), "stage3_prefetch_bucket_size")
    param_persistence_threshold: int = alias(int(1e5), "stage3_param_persistence_threshold")
    model_persistence_threshold: int = alias(int(2**62), "stage3_model_persistence_threshold")
    max_live_parameters: int = alias(int(1e9), "stage3_max_live_parameters")
    max_reuse_distance: int = alias(int(1e9), "stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = alias(
        False, "stage3_gather_16bit_weights_on_model_save")
    stage3_gather_fp16_weights_on_model_save: bool = dataclasses.field(
        default=False,
        metadata={"deprecated": True, "new_param": "gather_16bit_weights_on_model_save"})

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    # the mesh axis the partitioning rides on (with fsdp when present)
    partition_axis: str = "dp"

    def __init__(self, **data):
        known = {f.name for f in dataclasses.fields(self)} | {
            f.metadata["alias"] for f in dataclasses.fields(self) if "alias" in f.metadata}
        extra = sorted(k for k in data if k not in known)
        if extra:
            logger.warning(f"zero_optimization: keys {extra} are not ZeRO settings; ignored")
        super().__init__(**{k: v for k, v in data.items() if k in known})
        if not 0 <= self.stage <= 3:
            raise ValueError(f"zero_optimization.stage={self.stage} (expected 0..3)")
        for name in ("reduce_bucket_size", "allgather_bucket_size", "sub_group_size",
                     "prefetch_bucket_size", "param_persistence_threshold",
                     "model_persistence_threshold", "max_live_parameters",
                     "max_reuse_distance"):
            if getattr(self, name) < 0:
                raise ValueError(f"zero_optimization.{name} must be >= 0")
        # the deprecated booleans name their replacing sections (the JAX
        # fields' new_param_fn)
        if self.cpu_offload_param and self.offload_param is None:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
        if self.cpu_offload and self.offload_optimizer is None:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        if self.overlap_comm is None:
            # the reference default: True for stage 3, False otherwise
            self.overlap_comm = self.stage == 3

    @property
    def offload_optimizer_device(self) -> str:
        return self.offload_optimizer.device if self.offload_optimizer else "none"

    @property
    def offload_param_device(self) -> str:
        return self.offload_param.device if self.offload_param else "none"


__all__ = ["ZeroConfig", "get_zero_config", "read_zero_config_deprecated",
           "DeepSpeedZeroOffloadParamConfig", "DeepSpeedZeroOffloadOptimizerConfig",
           "ZERO_OPTIMIZATION"]
