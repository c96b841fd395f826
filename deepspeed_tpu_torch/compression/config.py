"""Compression config, the counterpart of ``deepspeed_tpu/compression/config.py``.

Returns nested dicts keyed like the reference JSON schema (weight
quantization, activation quantization, sparse/row/head/channel pruning,
layer reduction) with the JAX package's defaults filled in.
"""

from __future__ import annotations

import copy

from deepspeed_tpu_torch.config.config_utils import deep_update as _deep_update

COMPRESSION_TRAINING = "compression_training"

WEIGHT_QUANTIZATION = "weight_quantization"
ACTIVATION_QUANTIZATION = "activation_quantization"
SPARSE_PRUNING = "sparse_pruning"
ROW_PRUNING = "row_pruning"
HEAD_PRUNING = "head_pruning"
CHANNEL_PRUNING = "channel_pruning"
LAYER_REDUCTION = "layer_reduction"

SHARED_PARAMETERS = "shared_parameters"
DIFFERENT_GROUPS = "different_groups"

TECHNIQUE_ENABLED = "enabled"
TECHNIQUE_SCHEDULE_OFFSET = "schedule_offset"
TECHNIQUE_SCHEDULE_OFFSET_END = "schedule_offset_end"

_SHARED_DEFAULTS = {
    WEIGHT_QUANTIZATION: {
        "enabled": False,
        "quantizer_kernel": False,
        "schedule_offset": 0,
        "quantize_groups": 1,
        "quantize_verbose": False,
        "quantization_type": "symmetric",
        "quantize_weight_in_forward": False,
        "rounding": "nearest",
        "fp16_mixed_quantize": {
            "enabled": False,
            "quantize_change_ratio": 0.001,
        },
    },
    ACTIVATION_QUANTIZATION: {
        "enabled": False,
        "quantization_type": "symmetric",
        "range_calibration": "dynamic",
        "schedule_offset": 1000,
    },
    SPARSE_PRUNING: {
        "enabled": False,
        "method": "l1",
        "schedule_offset": 1000,
    },
    ROW_PRUNING: {
        "enabled": False,
        "method": "l1",
        "schedule_offset": 1000,
    },
    HEAD_PRUNING: {
        "enabled": False,
        "method": "topk",
        "schedule_offset": 1000,
    },
    CHANNEL_PRUNING: {
        "enabled": False,
        "method": "l1",
        "schedule_offset": 1000,
    },
}


def get_compression_config(param_dict: dict) -> dict:
    compression = param_dict.get(COMPRESSION_TRAINING, {})
    out = {LAYER_REDUCTION: {"enabled": False, **compression.get(LAYER_REDUCTION, {})}}
    for technique, defaults in _SHARED_DEFAULTS.items():
        section = compression.get(technique, {})
        out[technique] = {
            SHARED_PARAMETERS: _deep_update(defaults, section.get(SHARED_PARAMETERS, {})),
            DIFFERENT_GROUPS: copy.deepcopy(section.get(DIFFERENT_GROUPS, {})),
        }
    return out
