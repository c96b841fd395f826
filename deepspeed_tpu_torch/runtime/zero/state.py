"""The training engine's ZeRO stage 1-3 state on one rank (the port's
counterpart of the sharded ``TrainState`` that the JAX engine lays out with
``runtime/zero/partition.py``'s rules; reference ``stage_1_and_2.py`` and
``stage3.py``).

Over the flat units of ``partition.py``, rank ``r`` of the partition group
holds:

- the fp32 masters of block ``r`` of every unit (one flat fp32 block a
  unit), and the optimizer's state of the leaf segments in it (the
  optimizer is built over the segments, so its state is the segments');
- the engine's data-parallel gradient buffer (:func:`flat_buffer`, the
  one stage 0 uses too): at stage 1 the units back to back, whole, which
  the engine accumulates into and averages with one all-reduce as at stage
  0; at stages 2 and 3 the rank's blocks only: after each micro-step's
  backward every unit's gradients are reduce-scattered into the rank's
  block, in the buffer's dtype (at gas > 1 a micro-step reduces straight
  into the partition, as the JAX engine's sharded buffer does: one unit's
  flat copy in that dtype is alive at a time, and the buffer costs ``4 /
  n`` bytes a parameter where stage 1's costs 4; a stage-3 unit is
  reduce-scattered by its gather's backward, also in that dtype);
- at stages 1 and 2 the compute params whole, as views of one flat
  compute-dtype buffer a unit, refreshed after the update by one
  all-gather of the rank's updated block a unit; at stage 3 the
  :class:`~deepspeed_tpu_torch.runtime.zero.partition_parameters.PartitionedParams`
  (the blocks, with the units under the persistence threshold whole: those
  are refreshed as at stage 2).

With fp32 compute there are no masters: the rank's block of the compute
params is what the optimizer updates. A leaf's full value (a checkpoint,
``load_train_state``) is read by gathering its unit (:meth:`leaf`) and
written by each rank copying its own part (:meth:`set_leaf`, no
collective).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

import deepspeed_tpu_torch.comm as dist
from deepspeed_tpu_torch.runtime.zero.partition import Segment, Unit, ZeroShardingRules
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (
    PartitionedParams, _nest, pack_unit, unit_leaves)


class ZeroState:
    """One rank's partitioned training state (see the module docstring)."""

    def __init__(self, rules: ZeroShardingRules, units: List[Unit], order: List[str], group,
                 rank: int, world: int, device, compute_dtype, grad_acc_dtype,
                 mixed_precision: bool):
        self.rules, self.units, self.group = rules, units, group
        self.rank, self.world, self.stage = rank, world, rules.stage
        self.device, self.compute_dtype = device, compute_dtype
        self.grad_acc_dtype, self.mixed_precision = grad_acc_dtype, mixed_precision
        self.segments: List[List[Segment]] = [u.segments(rank) for u in units]
        self.where: Dict[str, Tuple[int, int]] = {}     # leaf -> (unit, index in unit)
        for ui, unit in enumerate(units):
            for i, n in enumerate(unit.names):
                self.where[n] = (ui, i)
        self._seg = {s.name: s for segs in self.segments for s in segs}
        #: the leaves with a segment on this rank, in the tree's flatten order
        #: (stage 0's order: the norms sum in it)
        self.names = [n for n in order if n in self._seg]
        self._cache: Dict[Any, Tuple[int, torch.Tensor]] = {}

    # ------------------------------------------------------------------ #
    # construction

    def build(self, given) -> None:
        """The state from the initial params: a full tree (leaves by name)
        or a :class:`PartitionedParams` of the same layout."""
        dev, cdt = self.device, self.compute_dtype
        if isinstance(given, PartitionedParams):
            if [u.names for u in given.units] != [u.names for u in self.units] or \
                    given.world != self.world:
                raise ValueError("the partitioned params were made for another layout or world")

        def unit_flat(ui):
            """Unit ui's whole flat buffer, or None for a block given alone."""
            unit = self.units[ui]
            if not isinstance(given, PartitionedParams):
                return pack_unit(unit, [given[n] for n in unit.names], torch.float32, dev)
            if self.stage < 3 or given.blocks[ui] is None:
                return given.gathered_flat(ui)
            return None

        self.cflat: List[Optional[torch.Tensor]] = [None] * len(self.units)
        master_src, pblocks, pflats = [], [], []
        for ui, unit in enumerate(self.units):
            lo, hi = self.rank * unit.block, (self.rank + 1) * unit.block
            flat = unit_flat(ui)
            part = flat[lo:hi] if flat is not None else given.blocks[ui].detach()
            master_src.append(part.to(dev, torch.float32, copy=True))
            if self.stage < 3:
                self.cflat[ui] = flat.to(dev, cdt, copy=True)
            elif self.rules.params_partitioned(unit.numel):
                pblocks.append(part.to(dev, cdt, copy=True))
                pflats.append(None)
            else:
                pblocks.append(None)
                pflats.append(flat.to(dev, cdt, copy=True))
            del flat, part
        if self.stage < 3:
            from deepspeed_tpu_torch.models.transformer import ParamTree
            # the tree's parameters share the flat buffers' storage
            self.params = ParamTree(_nest([(n, v) for ui, unit in enumerate(self.units)
                                           for n, v in zip(unit.names,
                                                           unit_leaves(unit, self.cflat[ui]))]),
                                    requires_grad=True)
        else:
            self.params = PartitionedParams(self.units, pblocks, pflats, self.group, self.rank,
                                            self.world, requires_grad=True)
            self.cflat = list(self.params.flats)
        # fp32 compute: the rank's block of the compute params is the target
        self.master_blocks = master_src if self.mixed_precision else \
            [self._compute_block(ui) for ui in range(len(self.units))]
        self.targets = {s.name: self._seg_view(self.master_blocks[ui], s, ui)
                        for ui, segs in enumerate(self.segments) for s in segs}

    def _compute_block(self, ui: int) -> torch.Tensor:
        unit = self.units[ui]
        if self.cflat[ui] is not None:
            return self.cflat[ui][self.rank * unit.block:(self.rank + 1) * unit.block]
        return self.params.blocks[ui].data

    def _seg_view(self, block: torch.Tensor, s: Segment, ui: int) -> torch.Tensor:
        """A segment's view of a block: the leaf's shape when the segment is
        the whole leaf, else flat."""
        v = block[s.block_lo:s.block_lo + s.numel]
        shape = self.units[ui].shapes[self.where[s.name][1]]
        return v.view(shape) if s.numel == math.prod(shape) else v

    def bind_acc(self, flat: torch.Tensor, unit_views: List[torch.Tensor]) -> None:
        """Take the engine's gradient buffer (:func:`flat_buffer` over these
        units: whole at stage 1, the rank's blocks at stages 2-3). ``grads``
        are the segment views the update reads; a stage-3 unit's gather
        reduces its gradient straight into its block."""
        self.acc, self.acc_units = flat, unit_views
        blocks = unit_views if self.stage >= 2 else [
            a[self.rank * u.block:(self.rank + 1) * u.block]
            for a, u in zip(unit_views, self.units)]
        self.grads = {s.name: self._seg_view(blocks[ui], s, ui)
                      for ui, segs in enumerate(self.segments) for s in segs}
        if self.stage >= 3:
            self.params.grad_sinks = [a if b is not None else None
                                      for a, b in zip(unit_views, self.params.blocks)]

    # ------------------------------------------------------------------ #
    # the step

    def accumulate(self) -> None:
        """Stages 2-3: reduce-scatter (sum) one micro-step's gradients of
        each whole unit into the rank's block of the buffer, in its dtype,
        and release them (a stage-3 partitioned unit's were reduced by its
        gather's backward)."""
        leaves = self._unit_params()
        for ui, unit in enumerate(self.units):
            if self.stage == 3 and self.params.blocks[ui] is not None:
                continue
            acc = self.acc_units[ui]
            flat = torch.zeros(unit.padded, dtype=acc.dtype, device=acc.device)
            for p, v in zip(leaves[ui], unit_leaves(unit, flat)):
                if p.grad is not None:
                    v.copy_(p.grad)
                    p.grad = None
            out = torch.empty_like(acc)
            dist.reduce_scatter_flat(flat, out, group=self.group)
            del flat
            acc.add_(out)

    def _unit_params(self) -> List[List[torch.Tensor]]:
        if self.stage < 3:
            named = dict(self.params.named_parameters())
            return [[named[n] for n in unit.names] for unit in self.units]
        return [self.params.unit_parameters(ui) for ui in range(len(self.units))]

    def refresh_params(self) -> None:
        """The compute params from the updated masters: the rank's block of
        each unit cast, then one all-gather a unit (a stage-3 partitioned
        unit keeps its block only)."""
        with torch.no_grad():
            for ui, unit in enumerate(self.units):
                if self.cflat[ui] is None:
                    if self.mixed_precision:
                        self.params.blocks[ui].copy_(self.master_blocks[ui])
                    continue
                block = self._compute_block(ui)
                if self.mixed_precision:
                    block.copy_(self.master_blocks[ui])
                dist.all_gather_flat(block.clone(), self.cflat[ui], group=self.group)

    # ------------------------------------------------------------------ #
    # full leaves (checkpoints, loads, fingerprints)

    def _blocks(self, kind) -> List[torch.Tensor]:
        """The rank's per-unit blocks of "master" or "acc" (stages 2-3)."""
        return self.master_blocks if kind == "master" else self.acc_units

    def _gathered_unit(self, kind, ui: int, opt_state=None) -> torch.Tensor:
        """Unit ``ui``'s whole flat buffer of ``kind``: "params", "master",
        "acc" or ``("opt", field)`` (a collective for a partitioned kind);
        the last one gathered of each kind is kept."""
        hit = self._cache.get(kind)
        if hit is not None and hit[0] == ui:
            return hit[1]
        unit = self.units[ui]
        if kind == "params":
            flat = self.cflat[ui] if self.cflat[ui] is not None else \
                self.params.gathered_flat(ui)
        elif kind == "acc" and self.stage == 1:
            flat = self.acc_units[ui]
        else:
            if isinstance(kind, tuple):
                block = torch.zeros(unit.block, dtype=torch.float32, device=self.device)
                named = getattr(opt_state, kind[1])
                for s in self.segments[ui]:
                    block[s.block_lo:s.block_lo + s.numel].copy_(named[s.name].reshape(-1))
            else:
                block = self._blocks(kind)[ui]
            flat = torch.empty(unit.padded, dtype=block.dtype, device=block.device)
            dist.all_gather_flat(block.detach(), flat, group=self.group)
        self._cache[kind] = (ui, flat)
        return flat

    def leaf(self, kind, name: str, opt_state=None) -> torch.Tensor:
        """Leaf ``name``'s full value of ``kind`` (a new tensor)."""
        ui, i = self.where[name]
        flat = self._gathered_unit(kind, ui, opt_state)
        return unit_leaves(self.units[ui], flat)[i].detach().clone()

    def clear_cache(self) -> None:
        self._cache = {}

    def set_leaf(self, kind, name: str, value, opt_state=None) -> None:
        """Write leaf ``name``'s full value of ``kind``: each rank copies the
        part it holds (no collective)."""
        ui, i = self.where[name]
        unit = self.units[ui]
        src = torch.as_tensor(value).reshape(-1)
        with torch.no_grad():
            if kind == "params" and self.cflat[ui] is not None:
                unit_leaves(unit, self.cflat[ui])[i].copy_(src.view(unit.shapes[i]))
                return
            if kind == "acc" and self.stage == 1:
                unit_leaves(unit, self.acc_units[ui])[i].copy_(src.view(unit.shapes[i]))
                return
            s = self._seg.get(name)
            if s is None:
                return
            part = src[s.lo:s.hi]
            if kind == "params":
                self.params.blocks[ui].data[s.block_lo:s.block_lo + s.numel].copy_(part)
            elif isinstance(kind, tuple):
                getattr(opt_state, kind[1])[name].view(-1).copy_(part)
            else:
                self._blocks(kind)[ui][s.block_lo:s.block_lo + s.numel].copy_(part)

    def shape(self, name: str) -> Tuple[int, ...]:
        ui, i = self.where[name]
        return tuple(self.units[ui].shapes[i])

    # ------------------------------------------------------------------ #
    # accounting

    def held_bytes(self, opt_state=None) -> Dict[str, int]:
        """Bytes this rank holds outside a gather window: compute params,
        fp32 masters (0 with fp32 compute), optimizer state, accumulation
        buffer."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)
        if self.stage < 3:
            params = nbytes(self.cflat)
        else:
            params = self.params.held_bytes()
        opt = 0
        if opt_state is not None:
            for field in getattr(opt_state, "FIELDS", ()):
                opt += nbytes(getattr(opt_state, field).values())
        return {"params": params,
                "master": nbytes(self.master_blocks) if self.mixed_precision else 0,
                "optimizer": opt, "grads": nbytes([self.acc])}


def flat_buffer(units: List[Unit], dtype, device, rank: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The data-parallel gradient buffer over ``units``: one zeroed flat
    tensor of the units back to back (each leaf at its 64-element offset),
    or of their blocks only (``rank`` given), and its per-unit views."""
    sizes = [u.padded if rank is None else u.block for u in units]
    flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
    return flat, list(flat.split(sizes))


__all__ = ["ZeroState", "flat_buffer"]
