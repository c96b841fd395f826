"""Dotted leaf keys (counterpart of ``deepspeed_tpu/utils/pytree.py``): the
one naming scheme that checkpoint files and the tools that read them share.

``leaf_key`` takes a path of keys, or of objects carrying ``.key`` or
``.idx`` as JAX's path entries do; ``leaf_paths`` flattens a nested dict
(and, with ``descend_sequences``, list / tuple) tree of tensors or arrays;
``tree_leaves`` lists a tree's leaves in order."""

from __future__ import annotations

from typing import Any, Dict


def leaf_key(path) -> str:
    """Path -> dotted key. "." separator: keys double as file names, so no
    os.sep."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def leaf_paths(tree: Any, prefix: str = "", *,
               descend_sequences: bool = False) -> Dict[str, Any]:
    """Flatten a nested dict tree into {'a.b.c': leaf}. With
    ``descend_sequences``, list/tuple nodes flatten too, their indices as
    key segments ({'a.0.c': leaf}) — the checkpoint on-disk key scheme; the
    default keeps sequences as leaves. Empty containers vanish."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = list(tree.items())
    elif descend_sequences and isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        out[prefix[:-1]] = tree
        return out
    for k, v in items:
        out.update(leaf_paths(v, prefix + str(k) + ".",
                              descend_sequences=descend_sequences))
    return out


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict / list / tuple tree in order, a module
    (a ``ParamTree``) standing for its state tensors."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if callable(getattr(tree, "state_dict", None)):
        return list(tree.state_dict(keep_vars=True).values())
    return [tree]
