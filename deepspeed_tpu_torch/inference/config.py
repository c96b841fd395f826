"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``):
the same sections, fields, defaults and aliases, on dataclasses instead of
pydantic. Every field the JAX package has is accepted; the engine refuses
the settings this slice of the port does not serve yet
(``InferenceEngine._refuse_outside_slice``)."""

from __future__ import annotations

import dataclasses
from dataclasses import field
from enum import Enum
from typing import Any, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.config.config_utils import ConfigModel, alias, sub
from deepspeed_tpu_torch.monitor.config import TelemetryConfig, get_telemetry_config
from deepspeed_tpu_torch.utils.logging import warn_once

config = dataclasses.dataclass(init=False)


class DtypeEnum(str, Enum):
    fp32 = "fp32"
    fp16 = "fp16"
    bf16 = "bf16"
    int8 = "int8"

    @classmethod
    def from_any(cls, value) -> "DtypeEnum":
        if isinstance(value, cls):
            return value
        aliases = {
            "float32": "fp32", "float": "fp32", "fp32": "fp32",
            "float16": "fp16", "half": "fp16", "fp16": "fp16",
            "bfloat16": "bf16", "bf16": "bf16",
            "int8": "int8",
        }
        name = str(value).replace("torch.", "").replace("jnp.", "")
        if name not in aliases:
            raise ValueError(f"Unsupported dtype: {value}")
        return cls(aliases[name])

    @property
    def torch(self):
        return {DtypeEnum.fp32: torch.float32, DtypeEnum.fp16: torch.float16,
                DtypeEnum.bf16: torch.bfloat16, DtypeEnum.int8: torch.int8}[self]


class MoETypeEnum(str, Enum):
    residual = "residual"
    standard = "standard"


class QuantTypeEnum(str, Enum):
    asym = "asymmetric"
    sym = "symmetric"


@config
class DeepSpeedTPConfig(ConfigModel):
    """Tensor-parallel config ("tensor_parallel" section)."""
    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


@config
class DeepSpeedMoEConfig(ConfigModel):
    """MoE inference config ("moe" section)."""
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = alias([1], "num_experts")
    type: str = MoETypeEnum.standard.value
    ep_mp_group: Optional[Any] = None
    ep_group: Optional[Any] = None


@config
class BaseQuantConfig(ConfigModel):
    enabled: bool = True
    num_bits: int = 8
    q_type: str = QuantTypeEnum.sym.value
    q_groups: int = 1


@config
class WeightQuantConfig(BaseQuantConfig):
    quantized_initialization: Dict = field(default_factory=dict)
    post_init_quant: Dict = field(default_factory=dict)


@config
class ActivationQuantConfig(BaseQuantConfig):
    pass


@config
class QKVQuantConfig(ConfigModel):
    enabled: bool = True


@config
class QuantizationConfig(ConfigModel):
    enabled: bool = True
    activation: ActivationQuantConfig = sub(ActivationQuantConfig)
    weight: WeightQuantConfig = sub(WeightQuantConfig)
    qkv: QKVQuantConfig = sub(QKVQuantConfig)


@config
class SpeculativeConfig(ConfigModel):
    """Speculative decoding ("serving.speculative"): ``mode`` off | ngram |
    auto (auto is reserved and means off); ngram proposes up to ``k``
    tokens from the longest recurring tail n-gram of ``min_match`` ..
    ``max_match`` tokens (``inference/spec.py``), greedy serving only."""
    mode: str = "off"
    k: int = 4
    min_match: int = 2
    max_match: int = 4


@config
class KvHostConfig(ConfigModel):
    """Tiered KV cache ("serving.kv_host"): a host-RAM tier behind the block
    allocator. Not in this slice; the engine refuses ``enabled=True``."""
    enabled: bool = False
    max_host_blocks: int = 0
    spill: str = "auto"


@config
class ReplicaConfig(ConfigModel):
    """Replica scale-out ("serving.replicas"): the ``dp`` serving axis. Not
    in this slice; the engine refuses ``dp > 1``."""
    dp: int = 1
    roles: list = field(default_factory=list)
    affinity: str = "session"
    handoff: str = "auto"


@config
class ServingFaultConfig(ConfigModel):
    """Serving-plane fault tolerance ("serving.fault") for the always-on
    loop (``inference/serve.py``): per-request retries with logical-step
    backoff, engine restarts before the crash-loop breaker opens, and the
    queue depth above which queued work is shed (0 = off)."""
    max_request_retries: int = 3
    retry_backoff_steps: int = 2
    max_engine_restarts: int = 2
    restart_backoff_s: float = 0.0
    shed_queue_depth: int = 0


@config
class ServingConfig(ConfigModel):
    """Continuous-batching serving config ("serving" section), governing
    ``InferenceEngine.generate_batch``: the paged KV cache (block pools +
    per-request block tables) and the iteration-level scheduler.
    ``prefix_caching`` auto = on; ``prefill_chunk_tokens`` 0 = whole-prompt
    prefill; ``max_num_blocks`` 0 = auto-size so ``max_running`` requests
    can reach the model's max_seq."""
    block_size: int = 128          # tokens per KV block (128 = kernel path)
    max_num_blocks: int = 0        # pool blocks per layer; 0 = auto-size
    max_running: int = 8           # fused-decode width / running request cap
    paged: str = "auto"            # auto | on | off
    tp: int = 0                    # serving tensor-parallel degree
    prefix_caching: str = "auto"   # auto | on | off (auto = on when paged)
    prefill_chunk_tokens: int = 0  # 0 = whole-prompt; else chunk size
    kv_host: KvHostConfig = sub(KvHostConfig)
    replicas: ReplicaConfig = sub(ReplicaConfig)
    speculative: SpeculativeConfig = sub(SpeculativeConfig)
    fault: ServingFaultConfig = sub(ServingFaultConfig)
    policy: Union[str, Dict[str, Any]] = "fifo"


@config
class InferenceCheckpointConfig(ConfigModel):
    checkpoint_dir: Optional[str] = None
    save_mp_checkpoint_path: Optional[str] = None
    base_dir: Optional[str] = None


def _deprecated(default, new_param: str, alias_name: str = None):
    meta = {"deprecated": True, "new_param": new_param}
    if alias_name:
        return alias(default, alias_name, **meta)
    if isinstance(default, list):
        return field(default_factory=lambda: list(default), metadata=meta)
    return field(default=default, metadata=meta)


@config
class DeepSpeedInferenceConfig(ConfigModel):
    """Master inference config (``init_inference`` keyword set)."""

    replace_with_kernel_inject: bool = alias(False, "kernel_inject")
    dtype: DtypeEnum = DtypeEnum.fp16
    tensor_parallel: DeepSpeedTPConfig = sub(DeepSpeedTPConfig, alias="tp")
    enable_cuda_graph: bool = False
    zero: Dict = field(default_factory=dict)
    triangular_masking: bool = alias(True, "tm")
    moe: Union[bool, DeepSpeedMoEConfig] = sub(DeepSpeedMoEConfig)
    quant: QuantizationConfig = sub(QuantizationConfig)
    checkpoint: Optional[Union[str, Dict]] = None
    base_dir: str = ""
    set_empty_params: bool = False
    save_mp_checkpoint_path: Optional[str] = None
    checkpoint_config: InferenceCheckpointConfig = sub(InferenceCheckpointConfig,
                                                       alias="ckpt_config")
    serving: ServingConfig = sub(ServingConfig)
    # serving telemetry (TTFT/TPOT histograms, queue depth, KV utilization,
    # the flight recorder): a dict, a bool or "on"/"off", parsed by
    # monitor/config.get_telemetry_config as in the JAX package
    telemetry: TelemetryConfig = sub(TelemetryConfig)
    return_tuple: bool = True
    training_mp_size: int = 1
    replace_method: str = "auto"
    injection_policy: Optional[Dict] = alias(None, "injection_dict")
    injection_policy_tuple: Optional[tuple] = None
    config: Optional[Dict] = alias(None, "args")
    max_out_tokens: int = alias(1024, "max_tokens")
    min_out_tokens: int = alias(1, "min_tokens")
    transposed_mode: bool = False
    mp_size: int = _deprecated(1, "tensor_parallel.tp_size")
    mpu: Optional[Any] = _deprecated(None, "tensor_parallel.mpu")
    ep_size: int = _deprecated(1, "moe.ep_size")
    ep_group: Optional[Any] = _deprecated(None, "moe.ep_group", "expert_group")
    ep_mp_group: Optional[Any] = _deprecated(None, "moe.ep_mp_group", "expert_mp_group")
    moe_experts: list = _deprecated([1], "moe.moe_experts")
    moe_type: str = _deprecated(MoETypeEnum.standard.value, "moe.type")

    def __init__(self, **data):
        if data.get("enable_cuda_graph"):
            warn_once("enable_cuda_graph is accepted and ignored: the port runs eagerly")
        if data.get("dtype") is not None:
            data["dtype"] = DtypeEnum.from_any(data["dtype"])
        moe = data.get("moe")
        if isinstance(moe, bool):
            data["moe"] = DeepSpeedMoEConfig(enabled=moe)
        if "telemetry" in data:
            # dicts too: the sub-blocks accept shorthands only
            # get_telemetry_config understands
            data["telemetry"] = get_telemetry_config({"telemetry": data["telemetry"]})
        super().__init__(**data)

    def telemetry_enabled(self) -> bool:
        """Whether ``telemetry`` switches anything on (JAX semantics: a bool,
        "on"/"off", or a dict with ``enabled`` or an enabled sub-block)."""
        return bool(self.telemetry.enabled)
