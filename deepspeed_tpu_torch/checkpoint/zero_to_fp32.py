"""Offline fp32 state-dict reconstruction (the port's copy of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``).

Reads a saved engine checkpoint tag (``state.npz``, written by either
package, plus any per-process ZeRO-Offload host-state npz files) WITHOUT
building an engine, takes the highest-precision copy of every parameter
(fp32 masters when present, else the stored params upcast), and writes one
``.npz`` file keyed by dotted parameter path, loadable anywhere with plain
numpy.

CLI::

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <checkpoint_dir> <output.npz> [--tag TAG]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.pytree import leaf_paths as _leaf_paths


def _resolve_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    if tag is not None:
        return str(tag)
    latest = os.path.join(checkpoint_dir, "latest")
    if not os.path.isfile(latest):
        raise FileNotFoundError(f"No 'latest' file in {checkpoint_dir}; pass --tag")
    with open(latest) as f:
        return f.read().strip()


def _host(leaf) -> np.ndarray:
    """A state leaf (numpy, or a torch bf16 tensor) as a numpy array; bf16
    upcast to fp32, which holds it exactly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None,
                                             _tree: Any = None) -> Dict[str, np.ndarray]:
    """A dict of fp32 numpy arrays keyed by dotted parameter path. ``_tree``:
    an already-read state tree, to avoid a second disk read."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    tag = _resolve_tag(checkpoint_dir, tag)

    tree = _tree
    if tree is None:
        from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import read_state_tree
        tree = read_state_tree(os.path.join(checkpoint_dir, tag))

    params = _leaf_paths(tree["params"])
    masters = _leaf_paths(tree["master"]) if tree.get("master") is not None else {}

    # ZeRO-Offload: host masters live in per-process npz files
    offload_masters: Dict[str, np.ndarray] = {}
    for npz_path in sorted(glob.glob(os.path.join(checkpoint_dir, tag, "offload_state_p*.npz"))):
        with np.load(npz_path) as z:
            for key in z.files:
                if key.startswith("masters|"):
                    offload_masters[key.split("|", 1)[1]] = z[key]

    out: Dict[str, np.ndarray] = {}
    for path, leaf in params.items():
        arr = _host(leaf)
        if path in masters:
            arr = _host(masters[path])
        elif path in offload_masters:
            arr = offload_masters[path].reshape(arr.shape)
        out[path] = np.ascontiguousarray(arr.astype(np.float32))
    return out


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> None:
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(f"Saved {len(sd)} fp32 tensors ({total:,} params) to {output_file}")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_dir", type=str)
    parser.add_argument("output_file", type=str)
    parser.add_argument("--tag", type=str, default=None)
    args = parser.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
