"""Meta-device / dtype-override model initialization (counterpart of
``deepspeed_tpu/utils/init_on_device.py``).

Reference parity: ``deepspeed/utils/init_on_device.py`` ``OnDevice``: a
context manager under which model construction materialises parameters as
a chosen dtype, or not at all (``device="meta"``: shapes and dtypes only,
no memory). The reference patches ``Tensor.__new__``; the port, like the
JAX package, wraps the models' ``init_params`` instead: under
``device="meta"`` the init runs with ``device="meta"`` (torch's meta
device: every tensor has a shape and a dtype and no storage), otherwise it
runs as called; either way floating-point leaves are then cast to the
requested dtype.

Usage::

    with deepspeed_tpu_torch.OnDevice(dtype=torch.bfloat16, device="meta"):
        params = model.init_params()        # a ParamTree of meta tensors

Every model's ``init_params`` in the port honors the context
(:func:`honors_on_device`). Meta trees feed memory estimation and flows
where the real weights arrive from a checkpoint loader instead of an RNG.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Optional

import torch

_local = threading.local()


class OnDevice:
    """Context manager selecting where/how ``init_params`` materialises.

    ``device``: ``"device"`` (normal init, wherever the call puts it) or
    ``"meta"`` (no allocation: a tree of tensors on torch's meta device).
    ``dtype``: optional override applied to floating-point leaves. The
    context is thread-local.
    """

    def __init__(self, dtype=None, device: str = "device", enabled: bool = True):
        if device not in ("device", "meta"):
            raise ValueError(f"device must be 'device' or 'meta', got {device!r}")
        self.dtype = dtype
        self.device = device
        self.enabled = enabled
        self._prev: Optional[OnDevice] = None

    @staticmethod
    def current() -> Optional["OnDevice"]:
        ctx = getattr(_local, "ctx", None)
        return ctx if ctx is not None and ctx.enabled else None

    def __enter__(self):
        # enabled=False is a no-op wrapper: an active outer context stays in
        # force (reference semantics: the patch simply isn't applied)
        if self.enabled:
            self._prev = getattr(_local, "ctx", None)
            _local.ctx = self
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _local.ctx = self._prev
        return False


def _cast_floats(tree, dtype):
    from deepspeed_tpu_torch.models.transformer import ParamTree, map_tree

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    if isinstance(tree, ParamTree):
        return tree.map(leaf, requires_grad=any(p.requires_grad for p in tree.parameters()))
    return map_tree(leaf, tree)


def materialize_params(init_fn, *args, **kwargs) -> Any:
    """Run a params-init function under the active :class:`OnDevice`
    context (a passthrough when none is active). ``init_fn`` takes a
    ``device`` keyword, which ``device="meta"`` sets to ``"meta"``. Under a
    ZeRO ``Init`` context the tree comes back partitioned
    (``runtime/zero/partition_parameters.Init.materialize``)."""
    from deepspeed_tpu_torch.runtime.zero.partition_parameters import active_init
    init = active_init()
    if init is not None:
        return init.materialize(lambda: _on_device(init_fn, *args, **kwargs))
    return _on_device(init_fn, *args, **kwargs)


def _on_device(init_fn, *args, **kwargs) -> Any:
    ctx = OnDevice.current()
    if ctx is None:
        return init_fn(*args, **kwargs)
    if ctx.device == "meta":
        kwargs = {**kwargs, "device": "meta"}
    tree = init_fn(*args, **kwargs)
    if ctx.dtype is not None:
        tree = _cast_floats(tree, ctx.dtype)
    return tree


def honors_on_device(init_method):
    """Decorator for ``init_params(self, generator=None, device=..., ...)``
    methods: the single place that expresses the OnDevice contract (applied
    to every params-producing entry so new model families cannot bypass
    the context). The call's own arguments are kept; under ``"meta"`` its
    ``device`` becomes ``"meta"``."""
    sig = inspect.signature(init_method)
    if "device" not in sig.parameters:
        raise TypeError(f"{init_method.__qualname__} takes no device argument")

    @functools.wraps(init_method)
    def wrapped(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        call = dict(bound.arguments)
        call.pop("self")
        return materialize_params(lambda **kw: init_method(self, **kw), **call)

    return wrapped
