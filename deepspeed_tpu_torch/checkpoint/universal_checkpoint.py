"""Universal checkpoint (the port's copy of
``deepspeed_tpu/checkpoint/universal_checkpoint.py``): a
topology-independent per-parameter layout.

``ds_to_universal`` explodes an engine checkpoint tag (written by either
package) into one file per parameter holding its fp32 weight and its Adam
moments. A universal checkpoint loads into a model at any layout: each leaf
reads the full logical array.

Layout::

    <out_dir>/
      meta.json                     # step counters, source config
      params/<dotted.path>.npz      # param (fp32), exp_avg, exp_avg_sq

Paths are the JAX package's: per-layer leaves are stacked ``[n_layer, ...]``
under ``layers.*`` (a pipeline tag's ``stages.*`` [S, L/S, ...] leaves are
stored as ``layers.*``, its ``head.*`` as top-level), so the port's
``layers.<i>.<leaf>`` reads row ``i`` of ``layers.<leaf>``."""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (_host, _leaf_paths, _resolve_tag,
                                                         get_fp32_state_dict_from_zero_checkpoint)


def _moments(tree, fp32, labels) -> Dict[str, Dict[str, np.ndarray]]:
    """{param path: {exp_avg, exp_avg_sq}} from the tag's optimizer state."""
    moments: Dict[str, Dict[str, np.ndarray]] = {p: {} for p in fp32}
    opt_flat = tree.get("opt_state_flat")
    if opt_flat and labels:
        # structured metadata written at save time: each flat leaf is
        # labelled with its moment kind + param path; extra optimizer state
        # is skipped
        kind_map = {"mu": "exp_avg", "nu": "exp_avg_sq"}
        for i, lab in enumerate(labels):
            kind = kind_map.get(lab.get("moment"))
            pname = lab.get("param")
            if kind and pname in moments:
                moments[pname][kind] = _host(opt_flat[f"leaf_{i}"]).astype(np.float32)
    elif opt_flat:
        # legacy checkpoints without labels: infer by runs of param-shaped
        # leaves ([count, mu..., nu...] for adam-family chains); refuse to
        # guess if the structure is ambiguous
        param_items = list(_leaf_paths(tree["params"]).items())
        n = len(param_items)
        param_shapes = [tuple(p.shape) for _, p in param_items]
        leaves = [_host(opt_flat[k]) for k in sorted(opt_flat, key=lambda s: int(s.split("_")[1]))]
        arrays = [a for a in leaves if a.shape != ()]
        runs = []
        i = 0
        while i + n <= len(arrays) and len(runs) < 2:
            if [a.shape for a in arrays[i:i + n]] == param_shapes:
                runs.append(arrays[i:i + n])
                i += n
            else:
                i += 1
        leftovers = len(arrays) - 2 * n
        if len(runs) != 2 or leftovers != 0:
            warnings.warn(
                f"ds_to_universal: optimizer state is ambiguous without labels "
                f"({len(runs)} shape-matched runs, {leftovers} leftover "
                f"non-scalar leaves); omitting moments: re-save the checkpoint "
                f"with this version to get labelled optimizer state")
            runs = []
        for name, run in zip(["exp_avg", "exp_avg_sq"], runs):
            for (pname, _), arr in zip(param_items, run):
                moments[pname][name] = arr.astype(np.float32)
    return moments


def _canon(pname, arr):
    """Pipeline topology out of the layout: "stages.*" [S, Lps, ...] ->
    "layers.*" [S * Lps, ...]; the pipeline's "head.*" -> top-level."""
    if pname.startswith("stages."):
        S, Lps = arr.shape[0], arr.shape[1]
        return "layers." + pname[len("stages."):], arr.reshape((S * Lps,) + arr.shape[2:])
    if pname.startswith("head."):
        return pname[len("head."):], arr
    return pname, arr


def ds_to_universal(checkpoint_dir: str, out_dir: str, tag: Optional[str] = None) -> None:
    """Convert an engine checkpoint tag into the universal layout."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import read_state_tree

    checkpoint_dir = os.path.abspath(checkpoint_dir)
    tag = _resolve_tag(checkpoint_dir, tag)
    tree = read_state_tree(os.path.join(checkpoint_dir, tag))
    fp32 = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag, _tree=tree)

    meta_src = os.path.join(checkpoint_dir, tag, "meta.json")
    source_meta = None
    if os.path.isfile(meta_src):
        with open(meta_src) as f:
            source_meta = json.load(f)
    moments = _moments(tree, fp32, (source_meta or {}).get("opt_state_labels"))

    params_dir = os.path.join(out_dir, "params")
    if os.path.isdir(params_dir) and os.listdir(params_dir):
        # canonicalization renames entries: stale files from an earlier
        # export would shadow fresh weights on load, so start clean
        shutil.rmtree(params_dir)
    os.makedirs(params_dir, exist_ok=True)
    for pname, arr in fp32.items():
        cname, carr = _canon(pname, arr)
        payload = {"param": carr}
        payload.update({k: _canon(pname, v)[1] for k, v in moments.get(pname, {}).items()})
        np.savez(os.path.join(params_dir, f"{cname}.npz"), **payload)

    meta: Dict[str, Any] = {"source_tag": tag, "format": "universal", "version": 1}
    if source_meta is not None:
        meta["source_meta"] = source_meta
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    print(f"Universal checkpoint with {len(fp32)} params written to {out_dir}")


def load_universal_state_dict(universal_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{dotted.path: {param, exp_avg?, exp_avg_sq?}} from a universal dir."""
    params_dir = os.path.join(universal_dir, "params")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for fname in sorted(os.listdir(params_dir)):
        if not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(params_dir, fname)) as z:
            out[fname[:-4]] = {k: z[k] for k in z.files}
    return out


def load_universal_into_params(universal_dir: str, params, dtype=None):
    """A new parameter tree with each leaf of ``params`` (a ParamTree or its
    nested dict) replaced by the stored fp32 weight, cast to ``dtype`` (the
    leaf's own when None) on the leaf's device. A layer leaf
    ``layers.<i>.<leaf>`` reads row ``i`` of the stored ``layers.<leaf>``
    (or of an old-format ``stages.<leaf>`` flattened)."""
    from deepspeed_tpu_torch.models import ParamTree

    sd = load_universal_state_dict(universal_dir)
    tree = params.to_dict() if isinstance(params, ParamTree) else params
    n_layer = len(tree.get("layers", ()))

    def top(dotted, shape):
        ent = sd.get(dotted)
        if ent is None:   # pipeline "head.X" <-> canonical top-level "X"
            ent = sd.get(dotted[len("head."):] if dotted.startswith("head.")
                         else "head." + dotted)
        if ent is None:
            raise KeyError(f"universal checkpoint missing parameter {dotted}")
        if ent["param"].shape != shape:
            raise ValueError(f"shape mismatch for {dotted}: ckpt "
                             f"{ent['param'].shape} vs model {shape}")
        return ent["param"]

    def layer_row(tail, i, shape):
        ent = sd.get("layers." + tail)
        if ent is not None:
            stacked = ent["param"]
        else:
            src = sd.get("stages." + tail)
            if src is None:
                raise KeyError(f"universal checkpoint missing parameter layers.{tail}")
            stacked = src["param"].reshape((-1,) + src["param"].shape[2:])
        if stacked.shape != (n_layer,) + shape:
            raise ValueError(f"shape mismatch for layers.{tail}: ckpt {stacked.shape} vs "
                             f"model {(n_layer,) + shape} ({n_layer} layers)")
        return stacked[i]

    def load(node, path):
        if isinstance(node, dict):
            return {k: load(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [load(v, path + (i,)) for i, v in enumerate(node)]
        shape = tuple(node.shape)
        if path[0] == "layers":
            arr = layer_row(".".join(path[2:]), path[1], shape)
        else:
            arr = top(".".join(path), shape)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=node.device, dtype=dtype or node.dtype)

    return ParamTree(load(tree, ()))
