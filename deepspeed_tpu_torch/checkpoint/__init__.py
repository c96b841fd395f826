"""Checkpoint conversion and interop (the port's copy of
``deepspeed_tpu/checkpoint/``): TP reshaping, external state-dict loaders,
pipeline stage re-stacking, universal checkpoints and the offline fp32
consolidation, over tags written by either package. ``from_jax`` carries
trees between the two packages in memory."""

from deepspeed_tpu_torch.checkpoint.reshape_pipeline import (layers_to_stages,
                                                             reshape_pipeline_checkpoint,
                                                             reshape_stages_tree,
                                                             stages_to_layers)
from deepspeed_tpu_torch.checkpoint.reshape_utils import (merge_qkv_shards, merge_tp_shards,
                                                          partition_data, split_qkv_shards,
                                                          split_tp_shards)
from deepspeed_tpu_torch.checkpoint.state_dict_factory import (MegatronSDLoader,
                                                               SDLoaderFactory,
                                                               load_state_dict_file)
from deepspeed_tpu_torch.checkpoint.universal_checkpoint import (ds_to_universal,
                                                                 load_universal_into_params,
                                                                 load_universal_state_dict)
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (
    convert_zero_checkpoint_to_fp32_state_dict, get_fp32_state_dict_from_zero_checkpoint)

__all__ = [
    "merge_tp_shards", "split_tp_shards", "merge_qkv_shards", "split_qkv_shards",
    "partition_data", "SDLoaderFactory", "MegatronSDLoader", "load_state_dict_file",
    "reshape_pipeline_checkpoint", "reshape_stages_tree", "stages_to_layers",
    "layers_to_stages",
    "ds_to_universal", "load_universal_state_dict", "load_universal_into_params",
    "convert_zero_checkpoint_to_fp32_state_dict", "get_fp32_state_dict_from_zero_checkpoint",
]
