"""Stage-3 parameters: flat units partitioned over the data-parallel ranks
and gathered on use, with ``Init`` and ``GatheredParameters`` (counterpart
of ``deepspeed_tpu/runtime/zero/__init__.py``; reference
``partition_parameters.py``).

:class:`PartitionedParams` holds a parameter tree as the flat units of
``runtime/zero/partition.py``: a partitioned unit as the rank's block (a
leaf tensor with ``requires_grad``), a unit under the persistence threshold
whole, its leaves views of one flat buffer. It reads like a
:class:`~deepspeed_tpu_torch.models.transformer.ParamTree` to the model:
``params["embed"]`` gathers the embedding's unit and returns its subtree,
kept for the rest of the forward (a tied head reads it again, so the unit
is gathered once and its two gradients are summed before the one
reduce-scatter); ``params["layers"]`` is a list of :class:`LayerUnit`,
which ``models/transformer.run_layers`` gathers inside each block, so under
a remat policy the recompute gathers it again and only the block is saved.

The gather is an autograd function (:class:`_GatherUnit`): its forward
all-gathers the unit's blocks into one flat buffer, its backward
reduce-scatters the unit's gradient into the rank's block (under the
engine straight into the rank's block of the accumulation buffer, in that
buffer's dtype, as stage 2 reduces). A gathered copy
does not live from the forward to the backward: under remat (the port's
default, ``TransformerConfig.remat = True``) a block's saved tensors are
dropped and the recompute gathers it again; without remat the engine's
forward runs under :meth:`PartitionedParams.saved_tensors_hooks`, which
keeps a saved view of a gathered buffer as its geometry and gathers the
unit again in the backward. Either way a layer's copy is alive only around
its own block (the embedding's and the head's for the whole forward, as
the tied head reads the embedding again).

``Init`` streams a model's ``init_params`` through the units: a layer's
leaves are cut into the rank's block as soon as the layer is made (the
port's transformer init hands each layer to :func:`stream_unit`), the
other units when the init returns; the values are eager init's, drawn from
the same generator in the same order. ``GatheredParameters`` gives mutable
full tensors and, on exit, broadcasts rank 0's copy (``modifier_rank``)
and re-partitions it, so every rank agrees as the JAX package's single
copy does; ``modifier_rank=None`` is read-only use.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch

import deepspeed_tpu_torch.comm as dist
from deepspeed_tpu_torch.runtime.zero.config import ZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition import Unit, ZeroShardingRules, build_units

_local = threading.local()


def _no_dispatch_modes():
    """The collectives run outside any remat policy's dispatch mode."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


class _GatherUnit(torch.autograd.Function):
    """block ``[B]`` -> the unit's flat buffer ``[n * B]`` (all-gather);
    the backward reduce-scatters the buffer's gradient (summed over the
    group) into the block's, or, where the engine gave the unit a gradient
    sink (its block of the accumulation buffer), in the sink's dtype into
    the sink, and the block gets no ``.grad``: one reduction precision at
    every stage."""

    @staticmethod
    def forward(ctx, block, owner, u):
        ctx.owner, ctx.u = owner, u
        with _no_dispatch_modes():
            return owner.gathered_flat(u)

    @staticmethod
    def backward(ctx, grad):
        owner = ctx.owner
        # the unit's backward is done: its copy gathered again for the
        # saved tensors (see PartitionedParams.saved_tensors_hooks) goes
        owner._regathered.pop(ctx.u, None)
        sink = owner.grad_sinks[ctx.u] if owner.grad_sinks is not None else None
        dtype = grad.dtype if sink is None else sink.dtype
        out = torch.empty(grad.numel() // owner.world, dtype=dtype, device=grad.device)
        with _no_dispatch_modes():
            dist.reduce_scatter_flat(grad.to(dtype).contiguous(), out, group=owner.group)
        if sink is None:
            return out, None, None
        sink.add_(out)
        return None, None, None


def _nest(pairs, strip: int = 0) -> Dict[str, Any]:
    """``[(dotted name, tensor)]`` -> nested dict (lists for integer keys),
    the first ``strip`` name parts dropped."""
    root: Dict[str, Any] = {}
    for name, t in pairs:
        parts = name.split(".")[strip:]
        node = root
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def unit_leaves(unit: Unit, flat: torch.Tensor) -> List[torch.Tensor]:
    """The unit's leaves as views of its flat buffer (through one split,
    whose backward concatenates the leaves' gradients)."""
    pieces = flat.split(unit.split_sizes())
    return [pieces[2 * i + 1].view(shape) for i, shape in enumerate(unit.shapes)]


def pack_unit(unit: Unit, leaves, dtype=None, device=None) -> torch.Tensor:
    """The unit's flat buffer (zeros in the gaps and the padding) from its
    leaves."""
    dtype = dtype or leaves[0].dtype
    device = device or leaves[0].device
    flat = torch.zeros(unit.padded, dtype=dtype, device=device)
    with torch.no_grad():
        for t, view in zip(leaves, unit_leaves(unit, flat)):
            view.copy_(t)
    return flat


class LayerUnit:
    """One partitioned layer as the model's layer loop sees it:
    :meth:`gather` returns its subtree (``run_layers`` calls it inside the
    block); item access gathers it once for the forward."""

    def __init__(self, owner: "PartitionedParams", index: int):
        self.owner, self.index = owner, index

    def gather(self) -> Dict[str, Any]:
        return self.owner._gather(self.index)

    def __getitem__(self, key):
        return self.owner._windowed(self.index)[key]


class PartitionedParams:
    """A parameter tree as stage-3 flat units over ``group`` (see the
    module docstring). ``blocks[u]`` is unit ``u``'s block on this rank for
    a partitioned unit, else None and ``flats[u]`` its whole flat buffer."""

    def __init__(self, units: List[Unit], blocks, flats, group, rank: int, world: int,
                 requires_grad: bool = False):
        self.units, self.flats = units, list(flats)
        self.blocks = [None if b is None else b.requires_grad_(requires_grad) for b in blocks]
        self.group, self.rank, self.world = group, rank, world
        self._window: Dict[int, Any] = {}
        # storage address -> (weakref to a gathered buffer, unit), and the
        # units gathered again in the backward (see saved_tensors_hooks)
        self._gathered: Dict[int, Any] = {}
        self._regathered: Dict[int, torch.Tensor] = {}
        #: the most gathered buffers alive at once (a gauge of the window)
        self.peak_live_gathers = 0
        #: per unit, the tensor its gather's backward adds the reduced
        #: gradient to (set by the engine's ZeroState), or None
        self.grad_sinks: Optional[List[Optional[torch.Tensor]]] = None
        # a whole unit's leaves: parameters sharing its flat buffer's storage
        self._leaves = {u: [torch.nn.Parameter(v, requires_grad=requires_grad)
                            for v in unit_leaves(unit, self.flats[u])]
                        for u, unit in enumerate(units) if self.flats[u] is not None}
        self._persistent = {u: _nest(zip(units[u].names, leaves),
                                     strip=2 if "." in units[u].key else 0)
                            for u, leaves in self._leaves.items()}
        self._top: Dict[str, Any] = {}
        for u, unit in enumerate(units):
            if "." in unit.key:
                top = unit.key.split(".")[0]
                self._top.setdefault(top, []).append(u)
            else:
                for name in unit.names:
                    self._top.setdefault(name.split(".")[0], u)

    # ---- what the model reads ----

    def _subtree(self, u: int, flat: torch.Tensor) -> Dict[str, Any]:
        unit = self.units[u]
        return _nest(zip(unit.names, unit_leaves(unit, flat)),
                     strip=2 if "." in unit.key else 0)

    def _gather(self, u: int) -> Dict[str, Any]:
        """Unit ``u``'s subtree: gathered (a partitioned unit) or its views."""
        if self.blocks[u] is None:
            return self._persistent[u]
        flat = _GatherUnit.apply(self.blocks[u], self, u)
        self._gathered = {k: v for k, v in self._gathered.items() if v[0]() is not None}
        self._gathered[flat.untyped_storage().data_ptr()] = (weakref.ref(flat), u)
        self.peak_live_gathers = max(self.peak_live_gathers, len(self._gathered))
        return self._subtree(u, flat)

    def saved_tensors_hooks(self):
        """Autograd's saved-tensor hooks for a forward over these params: a
        tensor saved for the backward that views a gathered buffer still
        alive is kept as (unit, view geometry) instead, so the gathered copy
        is freed after its block's forward; the backward gathers the unit
        again on first use and drops it when the unit's gradient is
        reduce-scattered. Inside a remat region the checkpoint's own hooks
        take precedence (its recompute gathers the block again)."""
        def pack(t):
            try:
                hit = self._gathered.get(t.untyped_storage().data_ptr())
            except (RuntimeError, NotImplementedError):
                return t
            if hit is None or hit[0]() is None:
                return t
            return (_SavedView, hit[1], t.shape, t.stride(), t.storage_offset())

        def unpack(x):
            if not (isinstance(x, tuple) and x and x[0] is _SavedView):
                return x
            _, u, shape, stride, offset = x
            flat = self._regathered.get(u)
            if flat is None:
                with _no_dispatch_modes():
                    flat = self._regathered[u] = self.gathered_flat(u)
            return flat.as_strided(shape, stride, offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    def _windowed(self, u: int) -> Dict[str, Any]:
        """Unit ``u`` gathered once for the current forward."""
        if u not in self._window:
            self._window[u] = self._gather(u)
        return self._window[u]

    def release(self) -> None:
        """End the forward's gather window: the units gathered by item
        access are dropped (the autograd graph keeps what it saved)."""
        self._window = {}

    def __getitem__(self, key):
        where = self._top[key]
        if isinstance(where, list):
            return [LayerUnit(self, u) if self.blocks[u] is not None else self._persistent[u]
                    for u in where]
        return self._windowed(where)[key]

    def get(self, key, default=None):
        return self[key] if key in self._top else default

    # ---- the engine's view ----

    def parameters(self):
        """The tensors autograd gives gradients to: each partitioned unit's
        block, each whole unit's leaves."""
        for u in range(len(self.units)):
            if self.blocks[u] is not None:
                yield self.blocks[u]
            else:
                yield from self._leaves[u]

    def unit_parameters(self, u: int) -> List[torch.Tensor]:
        """A whole unit's leaf parameters (none for a partitioned unit)."""
        return self._leaves.get(u, [])

    def held_bytes(self) -> int:
        """Bytes of compute params this rank holds outside a gather window."""
        return sum((b if b is not None else f).numel() * (b if b is not None else f).element_size()
                   for b, f in zip(self.blocks, self.flats))

    def gathered_flat(self, u: int) -> torch.Tensor:
        """Unit ``u``'s whole flat buffer, gathered (no autograd)."""
        if self.blocks[u] is None:
            return self.flats[u]
        b = self.blocks[u].detach()
        out = torch.empty(b.numel() * self.world, dtype=b.dtype, device=b.device)
        return dist.all_gather_flat(b, out, group=self.group)

    def full_named(self) -> Dict[str, torch.Tensor]:
        """Every leaf by name, gathered (a collective on every rank)."""
        out = {}
        for u, unit in enumerate(self.units):
            flat = self.gathered_flat(u)
            out.update(zip(unit.names, (t.detach() for t in unit_leaves(unit, flat))))
        return out

    def to_dict(self) -> Dict[str, Any]:
        """The whole tree, gathered, in the model's layout."""
        return _nest(self.full_named().items())

    def load_full(self, u: int, flat: torch.Tensor) -> None:
        """Unit ``u`` from its whole flat buffer (this rank keeps its block)."""
        with torch.no_grad():
            if self.blocks[u] is None:
                self.flats[u].copy_(flat)
            else:
                b = self.blocks[u]
                b.copy_(flat[self.rank * b.numel():(self.rank + 1) * b.numel()])


def active_init() -> Optional["Init"]:
    """The innermost enabled ``Init`` context, or None."""
    stack = getattr(_local, "init_stack", None)
    return stack[-1] if stack else None


def stream_unit(key: str, subtree):
    """A model's init hands each finished layer here (``key`` its unit,
    ``layers.<i>``): under an :class:`Init` the rank keeps its block of
    it and the layer's full tensors are dropped (meta placeholders go
    back); otherwise the subtree is returned as it is."""
    init = active_init()
    if init is None:
        return subtree
    return init._stream(key, subtree)


class Init:
    """Construct-time ZeRO-3 partitioning (reference ``zero.Init``)::

        with deepspeed_tpu_torch.zero.Init():
            params = model.init_params(gen)     # a PartitionedParams

    The partition group is the mesh's data-parallel axes (the JAX rules'
    partition axes; ``mesh`` defaults to ``comm``'s). ``config``: a
    ``ZeroConfig``, a ``zero_optimization`` dict or a whole config dict;
    the stage is raised to 3 (its persistence threshold applies).
    ``dtype`` casts the floating-point leaves."""

    def __init__(self, mesh=None, config: Optional[Any] = None, enabled: bool = True,
                 dtype=None):
        self.enabled = enabled
        self.mesh = mesh if mesh is not None else dist.get_mesh()
        if config is None:
            zcfg = ZeroConfig(stage=3)
        elif isinstance(config, ZeroConfig):
            zcfg = config
        else:
            zcfg = ZeroConfig(**(config.get("zero_optimization", config)
                                 if isinstance(config, dict) else {}))
        if zcfg.stage < 3:
            zcfg = copy.copy(zcfg)
            zcfg.stage = 3
        self.rules = ZeroShardingRules(self.mesh, zcfg)
        self.group = zero_group(self.mesh, self.rules)
        self.world = dist.get_world_size(self.group) if dist.has_process_group() else 1
        self.rank = dist.group_rank(self.group)
        self.dtype = dtype
        self._streamed: Dict[str, Any] = {}

    def __enter__(self):
        if self.enabled:
            stack = getattr(_local, "init_stack", None)
            if stack is None:
                stack = _local.init_stack = []
            stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _local.init_stack.pop()
        return False

    def _stream(self, key: str, subtree):
        """Keep this rank's block of one finished unit; meta placeholders
        back to the init."""
        from deepspeed_tpu_torch.models.transformer import ParamTree
        named = dict(ParamTree(subtree).named_parameters())
        unit, = build_units([(f"{key}.{n}", t.shape) for n, t in named.items()], self.world)
        leaves = [t.detach() for t in named.values()]
        dtype = self.dtype or leaves[0].dtype
        flat = pack_unit(unit, leaves, dtype)
        keep = flat if not self.rules.params_partitioned(unit.numel) else \
            flat[self.rank * unit.block:(self.rank + 1) * unit.block].clone()
        self._streamed[key] = keep
        del flat, leaves, named
        return _nest([(n, torch.empty(t.shape, dtype=dtype, device="meta"))
                      for n, t in ParamTree(subtree).named_parameters()])

    def materialize(self, init_fn, *args, **kwargs) -> PartitionedParams:
        """``init_fn(*args, **kwargs)`` (a params tree) as a
        :class:`PartitionedParams`, each streamed layer kept as its block."""
        from deepspeed_tpu_torch.models.transformer import ParamTree
        self._streamed = {}
        tree = init_fn(*args, **kwargs)
        named = dict((tree if isinstance(tree, ParamTree) else ParamTree(tree)).named_parameters())
        units = build_units([(n, t.shape) for n, t in named.items()], self.world)
        blocks, flats = [], []
        for unit in units:
            kept = self._streamed.pop(unit.key, None)
            part = self.rules.params_partitioned(unit.numel)
            if kept is None:
                leaves = [named[n].detach() for n in unit.names]
                flat = pack_unit(unit, leaves, self.dtype or leaves[0].dtype)
                kept = flat[self.rank * unit.block:(self.rank + 1) * unit.block].clone() \
                    if part else flat
            blocks.append(kept if part else None)
            flats.append(None if part else kept)
        del tree, named
        return PartitionedParams(units, blocks, flats, self.group, self.rank, self.world)


def zero_group(mesh, rules: ZeroShardingRules):
    """The axes a ZeRO partition spans: the rules' partition axes, or the
    mesh's data-parallel axes when they are of size 1 (a world of one rank
    still calls the backend over its group)."""
    return tuple(rules.axes) if rules.axes else tuple(dist.data_parallel_axes(mesh))


class GatheredParameters:
    """Gather partitioned parameters for user code (reference
    ``partition_parameters.py:1382``)::

        gp = GatheredParameters(params)          # a PartitionedParams
        with gp as full:
            full["embed"]["tokens"][0] = 0.0     # full torch tensors, mutable
        params = gp.params                       # re-partitioned in place

    On exit rank ``modifier_rank``'s tensors are broadcast over the group
    and every rank keeps its block of them; ``modifier_rank=None`` leaves
    the params as they were. A plain tree passes through unchanged. On an
    engine's stage-3 params this changes the compute params, not the fp32
    masters, as in the reference."""

    def __init__(self, params, modifier_rank: Optional[int] = 0, enabled: bool = True):
        self.params = params
        self.modifier_rank = modifier_rank
        self.enabled = enabled and isinstance(params, PartitionedParams)
        self._flats = None

    def __enter__(self):
        if not self.enabled:
            return self.params
        pp = self.params
        self._flats = [pp.gathered_flat(u).detach().clone() for u in range(len(pp.units))]
        return _nest([(n, t) for u, unit in enumerate(pp.units)
                      for n, t in zip(unit.names, unit_leaves(unit, self._flats[u]))])

    def __exit__(self, exc_type, *exc):
        if self.enabled and exc_type is None and self.modifier_rank is not None:
            pp = self.params
            for u, flat in enumerate(self._flats):
                flat = dist.broadcast(flat, src=self.modifier_rank, group=pp.group)
                pp.load_full(u, flat)
        self._flats = None
        return False


class _SavedView:
    """Marks a saved tensor kept as a view of a unit to gather again."""


@contextlib.contextmanager
def gather_window(params):
    """The forward's gather window of a :class:`PartitionedParams` (a
    no-op for any other tree): its saved-tensor hooks while the forward
    runs; item-access gathers end with it."""
    if not isinstance(params, PartitionedParams):
        yield params
        return
    try:
        with params.saved_tensors_hooks():
            yield params
    finally:
        params.release()


__all__ = ["PartitionedParams", "LayerUnit", "Init", "GatheredParameters",
           "stream_unit", "active_init", "zero_group", "gather_window", "unit_leaves",
           "pack_unit"]
