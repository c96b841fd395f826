"""Checkpoint loaders for external (HF / Megatron-style) state dicts (the
port's copy of ``deepspeed_tpu/checkpoint/state_dict_factory.py``).

Supports single-file torch checkpoints (``pytorch_model.bin``, loaded
memory-mapped) and safetensors files (the port's own reader), and the
``ds_inference`` checkpoint-meta json ({"type": ..., "checkpoints": [...],
"version": ...}). Loaders return ``{name: torch.Tensor}`` on the CPU in the
file's dtype (the JAX package returns numpy arrays, floats upcast to fp32:
the port casts where the tensor lands); TP merge and split are
:mod:`deepspeed_tpu_torch.checkpoint.reshape_utils`'s."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Union

import torch

from deepspeed_tpu_torch.checkpoint import _safetensors
from deepspeed_tpu_torch.checkpoint.reshape_utils import (merge_qkv_shards, merge_tp_shards,
                                                          split_qkv_shards, split_tp_shards)


def _load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "module" in sd and isinstance(sd["module"], dict):
        sd = sd["module"]  # DS-style wrapper
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return _safetensors.load_file(path)
    return _load_torch_file(path)


class SDLoaderFactory:
    """Entry point of the reference class."""

    @staticmethod
    def get_sd_loader_json(json_file_or_dict: Union[str, dict]):
        """Parse a ds_inference checkpoint-meta json -> (type, paths, version)."""
        if isinstance(json_file_or_dict, str):
            with open(json_file_or_dict) as f:
                data = json.load(f)
        else:
            data = json_file_or_dict
        sd_type = data.get("type", "Megatron")
        ckpt_list = data.get("checkpoints", [])
        if isinstance(ckpt_list, dict):  # BLOOM-style {"load": [...]}
            ckpt_list = ckpt_list.get("load", [])
        base = data.get("base_dir", "")
        paths = [os.path.join(base, c) if base else c for c in ckpt_list]
        version = data.get("version", 1.0)
        return sd_type, paths, version

    @staticmethod
    def get_sd_loader(ckpt_list: List[str], sd_type: str = "Megatron", version=None):
        return MegatronSDLoader(ckpt_list, version)


class MegatronSDLoader:
    """Loads a list of per-TP-rank checkpoint files and merges / splits them
    to a target TP degree."""

    def __init__(self, ckpt_list: List[str], version=None):
        self.ckpt_list = ckpt_list
        self.version = version

    @staticmethod
    def _strategy_for(name: str, merge_strategies: Dict[str, object]):
        """(dim, kind) for the first matching pattern; kind is 'plain' or
        'qkv'. A strategy is an int dim, or a (dim, 'qkv') tuple for FUSED
        query_key_value weights, which merge and split q/k/v-aware (a plain
        concatenation would interleave the q/k/v blocks)."""
        for pat, strat in merge_strategies.items():
            if pat in name:
                if isinstance(strat, (tuple, list)):
                    dim, kind = strat
                    return int(dim), str(kind)
                return int(strat), "plain"
        return None, None

    def load(self, mp_world_size: int = 1, mp_rank: int = 0,
             merge_strategies: Dict[str, object] = None) -> Dict[str, torch.Tensor]:
        """Merge all ranks' files into full tensors, then (optionally) slice
        for (mp_world_size, mp_rank). ``merge_strategies``: {substring:
        strategy}; weights no pattern matches must be identical replicas."""
        shards = [load_state_dict_file(p) for p in self.ckpt_list]
        merge_strategies = merge_strategies or {}

        full: Dict[str, torch.Tensor] = {}
        for name in shards[0]:
            parts = [s[name] for s in shards]
            dim, kind = self._strategy_for(name, merge_strategies)
            if dim is None or len(parts) == 1:
                full[name] = parts[0]
            elif kind == "qkv":
                full[name] = merge_qkv_shards(parts, dim)
            else:
                full[name] = merge_tp_shards(parts, dim)

        if mp_world_size <= 1:
            return full

        out: Dict[str, torch.Tensor] = {}
        for name, arr in full.items():
            dim, kind = self._strategy_for(name, merge_strategies)
            if dim is None:
                out[name] = arr
            elif kind == "qkv":
                out[name] = split_qkv_shards(arr, dim, mp_world_size)[mp_rank]
            else:
                out[name] = split_tp_shards(arr, dim, mp_world_size)[mp_rank]
        return out
