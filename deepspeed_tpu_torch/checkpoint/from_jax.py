"""Carry a parameter tree made by the JAX package into the port.

``deepspeed_tpu.models.transformer.init_params`` returns a pytree with
stacked ``[n_layer, ...]`` leaves under ``params["layers"]`` and ``[in, out]``
matmul weights. :func:`params_from_jax` takes that tree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``; this module never
imports JAX) and returns the port's
:class:`~deepspeed_tpu_torch.models.transformer.ParamTree`: the same keys,
the same layout, one sub-tree per layer."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import ParamTree, TransformerConfig


def _tensor(a, dtype):
    return torch.as_tensor(np.array(a, dtype=np.float32)).to(dtype)


def _convert(tree, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype) for k, v in tree.items()}
    return _tensor(tree, dtype)


def params_from_jax(cfg: TransformerConfig, tree: Dict[str, Any],
                    dtype=torch.float32) -> ParamTree:
    """The port's parameter tree from the JAX package's (numpy leaves)."""
    layers = tree["layers"]
    L = cfg.n_layer

    def layer(i):
        def take(x):
            if isinstance(x, dict):
                return {k: take(v) for k, v in x.items()}
            a = np.asarray(x)
            if a.shape[0] != L:
                raise ValueError(f"stacked layer leaf has leading dim {a.shape[0]}, "
                                 f"expected n_layer={L}")
            return _tensor(a[i], dtype)
        return take(layers)

    out = {k: _convert(v, dtype) for k, v in tree.items() if k != "layers"}
    out["layers"] = [layer(i) for i in range(L)]
    return ParamTree(out)
