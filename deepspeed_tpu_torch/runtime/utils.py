"""Gradient norms and clipping (the training subset of
``deepspeed_tpu/runtime/utils.py``: ``global_norm`` :111, ``clip_grad_norm_``
:118) over a list of tensors instead of a pytree, and the map from the
port's per-layer leaves to the JAX package's stacked leaves
(:func:`jax_leaves`)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, as a 0-dim
    tensor on the tensors' device (no host sync). ``tensors`` may be a
    generator: each is reduced before the next is drawn."""
    return norm_of_norms([torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors])


def norm_of_norms(norms: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm from per-tensor fp32 norms (what :func:`global_norm`
    computes after its per-tensor pass, so a caller that keeps the
    per-tensor norms gets the same bits)."""
    if not norms:
        return torch.tensor(0.0)
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def clip_grad_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                    norm: Optional[torch.Tensor] = None) -> Tuple[Sequence[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place to global norm at most ``max_norm``:
    ``g * min(1, max_norm / (norm + 1e-6))`` with ``norm`` the pre-clip
    global norm (computed when not given). Returns ``(grads, norm)``."""
    norm = global_norm(grads) if norm is None else norm
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return grads, norm


def jax_leaves(names: Iterable[str]) -> Dict[Tuple[str, ...], List[str]]:
    """The JAX leaves that the port's leaf names form, in the JAX package's
    flattened order (dict keys sorted at every level), each with its port
    names in layer order. The JAX package stacks the layers into one
    ``[n_layer, ...]`` leaf per key, so ``layers.0.attn.wq`` ...
    ``layers.{L-1}.attn.wq`` form the leaf ``("layers", "attn", "wq")``;
    every other name is a leaf of its own."""
    groups: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
            groups.setdefault(("layers",) + tuple(parts[2:]), []).append((int(parts[1]), name))
        else:
            groups.setdefault(tuple(parts), []).append((0, name))
    return {path: [n for _, n in sorted(groups[path])] for path in sorted(groups)}


def keystr(path: Sequence[str]) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: ``['layers']['attn']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)
