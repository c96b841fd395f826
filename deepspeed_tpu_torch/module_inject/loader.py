"""Streaming HF checkpoint loader (the port's copy of
``deepspeed_tpu/module_inject/loader.py``).

Multi-file checkpoints are read through a name -> file index; a tensor is
read on demand (a view of the memory-mapped safetensors shard, or of the
memory-mapped torch file), cast and moved straight to its device, and the
policy transposes or de-fuses it there. One shard is open at a time, so the
host holds one shard's mapped pages and no stacked tree: a Llama-2-7B in
bf16 fills the card one layer's tensor at a time."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.checkpoint._safetensors import SafetensorsFile
from deepspeed_tpu_torch.checkpoint.state_dict_factory import _load_torch_file

INDEX_FILES = ("model.safetensors.index.json", "pytorch_model.bin.index.json")
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def _read_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


class _TensorSource:
    """Lazy name -> tensor access over a single-file or index-sharded HF
    checkpoint (safetensors or torch ``.bin``). Every shard an index names
    must exist; the last shard read stays open, the one before is closed."""

    def __init__(self, path: str):
        self.path = path
        self.name_to_file: Dict[str, str] = {}
        self._open: Tuple[Optional[str], Any] = (None, None)

        if os.path.isfile(path):
            self._index_file(path)
            return
        idx = next((os.path.join(path, c) for c in INDEX_FILES
                    if os.path.exists(os.path.join(path, c))), None)
        if idx is not None:
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            for name, fname in weight_map.items():
                self.name_to_file[name] = os.path.join(path, fname)
            missing = sorted({f for f in self.name_to_file.values() if not os.path.isfile(f)})
            if missing:
                raise FileNotFoundError(f"{idx} names shards that are missing: {missing}")
            return
        for cand in WEIGHT_FILES:
            p = os.path.join(path, cand)
            if os.path.exists(p):
                self._index_file(p)
                return
        raise FileNotFoundError(
            f"no model.safetensors / pytorch_model.bin / *.index.json under {path}")

    def _index_file(self, fpath: str) -> None:
        for name in self._file(fpath).keys():
            self.name_to_file[name] = fpath

    def _file(self, fpath: str):
        """The open shard ``fpath`` (a SafetensorsFile, or a torch file's
        dict), closing the shard opened before it."""
        if self._open[0] != fpath:
            self.close()
            self._open = (fpath, SafetensorsFile(fpath) if fpath.endswith(".safetensors")
                          else _load_torch_file(fpath))
        return self._open[1]

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the CPU, a view of the mapped shard."""
        fpath = self.name_to_file.get(name)
        if fpath is None:
            raise KeyError(name)
        f = self._file(fpath)
        return f.get(name) if isinstance(f, SafetensorsFile) else f[name]

    def close(self) -> None:
        if isinstance(self._open[1], SafetensorsFile):
            self._open[1].close()
        self._open = (None, None)


def load_hf_checkpoint(path: str, model_type: Optional[str] = None, dtype=torch.float32,
                       config_overrides: Optional[Dict] = None, device="cpu"):
    """Load an HF checkpoint directory (or a single weights file with a
    config.json beside it) into ``(model, ParamTree)``, the tree's
    floating-point tensors in ``dtype`` on ``device``. The model is the
    policy's (``HFPolicy.build_model``: ``BertModel``, a CLIP encoder or
    ``DSClipEncoder`` for the encoder families), else ``CausalLM(cfg)``.

    ``model_type`` defaults to config.json's. Each tensor streams from its
    shard to the device on its own. ``config_overrides`` tweak the model
    config (e.g. ``{"attention_backend": "xla"}``). The default, an fp32
    tree on the CPU, is the JAX package's result (``params_from_jax`` of
    its fp32 tree); any other dtype is that tree cast, bit for bit (only
    data moves between a shard and the tree)."""
    from deepspeed_tpu_torch.models import CausalLM, ParamTree
    from deepspeed_tpu_torch.module_inject.policies import policy_for

    d = path if os.path.isdir(path) else os.path.dirname(path)
    hf_cfg = _read_config(d)
    policy = policy_for(model_type or hf_cfg.get("model_type"))
    cfg = policy.zoo_config(hf_cfg)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)

    device = torch.device(device)
    src = _TensorSource(path)

    def get(name: str) -> torch.Tensor:
        t = src.get(name)
        return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype,
                    copy=True)

    try:
        tree = policy.map_params(get, cfg)
    finally:
        src.close()
    model = policy.build_model(cfg, hf_cfg, tree)
    return (CausalLM(cfg) if model is None else model), ParamTree(tree)
