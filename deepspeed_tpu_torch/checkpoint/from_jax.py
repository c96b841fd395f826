"""Carry state between the JAX package and the port, both ways.

``deepspeed_tpu.models.transformer.init_params`` returns a pytree with
stacked ``[n_layer, ...]`` leaves under ``params["layers"]`` and ``[in, out]``
matmul weights. :func:`params_from_jax` takes that tree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``; this module never
imports JAX) and returns the port's
:class:`~deepspeed_tpu_torch.models.transformer.ParamTree`: the same keys,
the same layout, one sub-tree per layer. :func:`params_to_jax` goes back.
:func:`adam_state_from_jax` carries the JAX optimizer's Adam moments and
step count (optax ``ScaleByAdamState`` or the fused ``FusedAdamState``) into
the port's :class:`~deepspeed_tpu_torch.runtime.optimizers.AdamState`, and
:func:`opt_state_from_jax` the state of any engine-built optimizer (the
LAMB moments, SGD's trace, Lion's momentum, Adagrad's sum of squares), so a
run started in one package resumes in the other. :func:`opt_state_to_jax`
goes back: the JAX engine's flattened optimizer state, keyed by
``keystr`` path in its flatten order (``jax.tree.unflatten`` of the JAX
engine's treedef over ``list(values())`` rebuilds its state).

An int8 weight (the JAX package's ``Quantized8`` node: an int8 payload and
fp32 scales grouped over the last axis) crosses as one: its stacked
``[L, in, out]`` payload and ``[L, in, groups]`` scales split into the
port's per-layer :class:`~deepspeed_tpu_torch.ops.quant.Quantized8` leaves
(grouping is per row, so a layer's slice is what quantizing that layer
alone gives, bit for bit), and :func:`params_to_jax` stacks them back into
:class:`QuantizedArrays` (``Quantized8(q=..., scale=...)`` on the JAX
side)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import ParamTree, TransformerConfig, map_tree
from deepspeed_tpu_torch.config import core as config_core
from deepspeed_tpu_torch.ops.quant import Quantized8
from deepspeed_tpu_torch.runtime.optimizers import (AdagradState, AdamState, LionState,
                                                    SGDState, jax_state_layout)
from deepspeed_tpu_torch.runtime.utils import jax_leaves, keystr


@dataclasses.dataclass
class QuantizedArrays:
    """An int8 weight in the JAX package's layout, as numpy: ``q`` int8
    and ``scale`` fp32 (the fields of its ``Quantized8`` node)."""
    q: np.ndarray
    scale: np.ndarray


def _is_quantized(x) -> bool:
    """A JAX ``Quantized8`` node (or :class:`QuantizedArrays`): the port
    never imports the JAX package, so it goes by the node's two fields."""
    return not isinstance(x, (dict, np.ndarray)) and hasattr(x, "q") and hasattr(x, "scale")


def _quantized(q, scale) -> Quantized8:
    return Quantized8(torch.as_tensor(np.array(q, dtype=np.int8)),
                      torch.as_tensor(np.array(scale, dtype=np.float32)))


def _tensor(a, dtype):
    if _is_quantized(a):
        return _quantized(a.q, a.scale)
    return torch.as_tensor(np.array(a, dtype=np.float32)).to(dtype)


def params_from_jax(cfg: TransformerConfig, tree: Dict[str, Any],
                    dtype=torch.float32) -> ParamTree:
    """The port's parameter tree from the JAX package's (numpy leaves)."""
    layers = tree["layers"]
    L = cfg.n_layer

    def layer(i):
        def take(x):
            if isinstance(x, dict):
                return {k: take(v) for k, v in x.items()}
            if _is_quantized(x):
                if np.shape(x.q)[0] != L:
                    raise ValueError(f"stacked int8 leaf has leading dim {np.shape(x.q)[0]}, "
                                     f"expected n_layer={L}")
                return _quantized(np.asarray(x.q)[i], np.asarray(x.scale)[i])
            a = np.asarray(x)
            if a.shape[0] != L:
                raise ValueError(f"stacked layer leaf has leading dim {a.shape[0]}, "
                                 f"expected n_layer={L}")
            return _tensor(a[i], dtype)
        return take(layers)

    out = {k: map_tree(lambda a: _tensor(a, dtype), v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [layer(i) for i in range(L)]
    return ParamTree(out)


def params_to_jax(cfg: TransformerConfig, tree) -> Dict[str, Any]:
    """The JAX package's layout (stacked ``[n_layer, ...]`` layer leaves,
    numpy fp32; an int8 weight as :class:`QuantizedArrays`) from the port's
    tree (a ParamTree or its nested dict)."""
    if isinstance(tree, ParamTree):
        tree = tree.to_dict()

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, Quantized8):
            return QuantizedArrays(x.q.detach().cpu().numpy(), x.scale.detach().cpu().numpy())
        return torch.as_tensor(x).detach().to("cpu", torch.float32).numpy()

    layers = [host(lp) for lp in tree["layers"]]
    if len(layers) != cfg.n_layer:
        raise ValueError(f"{len(layers)} layer trees, expected n_layer={cfg.n_layer}")

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], QuantizedArrays):
            return QuantizedArrays(np.stack([lf.q for lf in leaves]),
                                   np.stack([lf.scale for lf in leaves]))
        return np.stack(leaves)

    out = {k: host(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = stack(*layers)
    return out


def clip_params_from_jax(model, tree: Dict[str, Any], dtype=torch.float32) -> ParamTree:
    """A ``DSClipEncoder``'s tree from the JAX package's two-tower tree
    (``{"text", "vision", ["logit_scale"]}``, numpy leaves): each tower by
    :func:`params_from_jax` with its own config, ``logit_scale`` as is. A
    ``BertModel``'s or a single tower's tree goes through
    :func:`params_from_jax` with ``model.config``."""
    out = {name: params_from_jax(getattr(model, name).config, tree[name], dtype).to_dict()
           for name in ("text", "vision") if name in tree}
    if "logit_scale" in tree:
        out["logit_scale"] = _tensor(tree["logit_scale"], dtype)
    return ParamTree(out)


def clip_params_to_jax(model, tree) -> Dict[str, Any]:
    """:func:`clip_params_from_jax` back: the JAX package's two-tower tree."""
    if isinstance(tree, ParamTree):
        tree = tree.to_dict()
    out = {name: params_to_jax(getattr(model, name).config, tree[name])
           for name in ("text", "vision") if name in tree}
    if "logit_scale" in tree:
        out["logit_scale"] = torch.as_tensor(tree["logit_scale"]).detach().to(
            "cpu", torch.float32).numpy()
    return out


def _find(state, attrs=("mu", "nu", "count")):
    """The node of a JAX optimizer state that holds ``attrs`` (the state
    itself, or an element of an optax chain's tuple)."""
    if all(hasattr(state, a) for a in attrs):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find(s, attrs)
            if found is not None:
                return found
    return None


def _named(cfg, tree):
    return {n: p.data for n, p in params_from_jax(cfg, tree).named_parameters()}


def adam_state_from_jax(cfg: TransformerConfig, opt_state) -> AdamState:
    """The port's Adam state from the JAX engine's ``state.opt_state``
    (leaves as numpy: ``jax.tree.map(np.asarray, opt_state)``), for the
    engine-built adam / adamw / fusedadam. Moments come back in fp32, keyed
    by the port's leaf names."""
    node = _find(opt_state)
    if node is None:
        raise ValueError("no Adam state (mu, nu, count) in this optimizer state")
    return AdamState(count=int(np.asarray(node.count)), mu=_named(cfg, node.mu),
                     nu=_named(cfg, node.nu))


def opt_state_from_jax(cfg: TransformerConfig, name: str, opt_state):
    """The port's optimizer state for config ``optimizer.type`` ``name`` from
    the JAX engine's ``state.opt_state`` (numpy leaves): the Adam family and
    lamb / fusedlamb (``ScaleByAdamState`` in the optax chain or
    ``FusedLambState``) -> ``AdamState``; sgd (``TraceState.trace``) ->
    ``SGDState``; lion (``ScaleByLionState``: mu, count) -> ``LionState``;
    adagrad (``ScaleByRssState.sum_of_squares``) -> ``AdagradState``. The
    JAX trace and sum-of-squares states keep no count: theirs comes back 0
    (neither optimizer reads it)."""
    name = name.lower()
    if name == config_core.SGD_OPTIMIZER:
        node = _find(opt_state, ("trace",))
        if node is None:
            raise ValueError("no TraceState (trace) in this optimizer state")
        return SGDState(count=0, trace=_named(cfg, node.trace))
    if name == config_core.ADAGRAD_OPTIMIZER:
        node = _find(opt_state, ("sum_of_squares",))
        if node is None:
            raise ValueError("no ScaleByRssState (sum_of_squares) in this optimizer state")
        return AdagradState(count=0, sum_of_squares=_named(cfg, node.sum_of_squares))
    if name == config_core.LION_OPTIMIZER:
        node = _find(opt_state, ("mu", "count"))
        if node is None:
            raise ValueError("no ScaleByLionState (mu, count) in this optimizer state")
        return LionState(count=int(np.asarray(node.count)), mu=_named(cfg, node.mu))
    return adam_state_from_jax(cfg, opt_state)


def opt_state_to_jax(name: str, opt_state, params=None) -> Dict[str, np.ndarray]:
    """The JAX engine's flattened optimizer state for config
    ``optimizer.type`` ``name`` (and ``optimizer.params`` ``params``) from
    the port's state: ``{keystr path: numpy leaf}`` in the JAX flatten
    order, the per-layer moments stacked into ``[n_layer, ...]`` fp32
    leaves, ``count`` a 0-d int32."""
    prefix, fields = jax_state_layout(name, params)
    out: Dict[str, np.ndarray] = {}
    for field in fields:
        if field == "count":
            out[prefix + ".count"] = np.asarray(opt_state.count, np.int32)
            continue
        named = getattr(opt_state, field)
        for path, names in jax_leaves(named).items():
            host = [named[n].detach().to("cpu", torch.float32).numpy() for n in names]
            out[prefix + "." + field + keystr(path)] = (np.stack(host) if path[0] == "layers"
                                                       else host[0])
    return out
