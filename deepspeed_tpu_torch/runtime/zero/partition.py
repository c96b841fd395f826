"""Which rank holds which elements of which leaf at which ZeRO stage
(counterpart of ``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package states ZeRO as sharding rules: stage 1 shards the fp32
masters and the optimizer state over the partition axes, stage 2 the
gradients too, stage 3 the compute params as well (small arrays stay whole),
each array along its largest divisible dim, and XLA inserts the
all-gathers and reduce-scatters. The port issues them itself, so it lays
the parameters out in **flat units**, the idiom of the reference's
``stage_1_and_2.py`` flat groups and of PyTorch's FSDP: one unit for the
embedding, one a layer, one for the final norm with the head (the names
after the last layer). A unit is one flat buffer holding its leaves in name
order, each leaf starting on a multiple of :data:`FLAT_ALIGN` elements,
padded to a multiple of ``n * FLAT_ALIGN``; rank ``r`` of the ``n`` ranks
of the partition group holds block ``r``, and a leaf's *segment* on a rank
is the part of it that falls in the rank's block (at most one, since both
are contiguous).

The layout differs from the JAX per-array choice (``_zero_spec``); the
values computed are the same, as each element is updated by the same
function wherever it is held (ROADMAP.md queue 3, fault 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.runtime.zero.config import ZeroConfig

#: each leaf starts on a multiple of this many elements (256 bytes in fp32),
#: so the kernels' vector loads stay aligned on every segment
FLAT_ALIGN = 64


def _partition_axes(mesh, zero_config: ZeroConfig) -> Tuple[str, ...]:
    """Mesh axes ZeRO partitions over: the configured axis plus fsdp if present."""
    axes = []
    for ax in (zero_config.partition_axis, "fsdp"):
        if ax in mesh.shape and mesh.shape[ax] > 1 and ax not in axes:
            axes.append(ax)
    return tuple(axes)


class ZeroShardingRules:
    """The stage and the partition axes over a mesh (``mesh.shape`` maps
    axis names to sizes), with the JAX rules' text (:meth:`describe`)."""

    def __init__(self, mesh, zero_config: Optional[ZeroConfig] = None):
        self.mesh = mesh
        self.config = zero_config or ZeroConfig()
        self.stage = self.config.stage
        self.axes = _partition_axes(mesh, self.config)
        self.axis_size = math.prod(mesh.shape[a] for a in self.axes) if self.axes else 1

    def params_partitioned(self, numel: int) -> bool:
        """Whether a unit of ``numel`` elements is partitioned at stage 3
        (the persistence threshold keeps small units whole)."""
        return self.stage >= 3 and numel >= int(self.config.param_persistence_threshold)

    def describe(self) -> str:
        return (f"ZeRO stage {self.stage} over axes {self.axes} (size {self.axis_size}); "
                f"params {'sharded' if self.stage >= 3 else 'replicated'}, "
                f"grads {'sharded' if self.stage >= 2 else 'replicated'}, "
                f"optimizer+master {'sharded' if self.stage >= 1 else 'replicated'}")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class Segment:
    """Leaf ``name``'s elements ``[lo, hi)`` (of its flattened view), held
    at ``block_lo`` of its unit's block on this rank."""
    name: str
    lo: int
    hi: int
    block_lo: int

    @property
    def numel(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass
class Unit:
    """One flat unit: its leaves in order, their shapes and offsets."""
    key: str
    names: List[str]
    shapes: List[Tuple[int, ...]]
    offsets: List[int]
    padded: int              # elements of the flat buffer (n * block)
    block: int               # elements a rank holds

    @property
    def numel(self) -> int:
        """Elements of the leaves themselves (no alignment or padding)."""
        return sum(math.prod(s) for s in self.shapes)

    def segments(self, rank: int) -> List[Segment]:
        """The leaves' segments in rank ``rank``'s block, in leaf order."""
        b0, b1 = rank * self.block, (rank + 1) * self.block
        out = []
        for name, off, shape in zip(self.names, self.offsets, self.shapes):
            lo, hi = max(off, b0), min(off + math.prod(shape), b1)
            if lo < hi:
                out.append(Segment(name, lo - off, hi - off, lo - b0))
        return out

    def split_sizes(self) -> List[int]:
        """Piece sizes that cut the flat buffer into its leaves and the
        gaps between them (leaf ``i`` is piece ``2 i + 1``)."""
        sizes, pos = [], 0
        for off, shape in zip(self.offsets, self.shapes):
            n = math.prod(shape)
            sizes += [off - pos, n]
            pos = off + n
        return sizes + [self.padded - pos]


#: the top-level key of the embedding's unit; every other key outside the
#: layer lists falls in the head's unit (the final norm, the head, its bias)
EMBED_KEY = "embed"
HEAD_UNIT = "head"


def unit_key(name: str) -> str:
    """The unit a leaf name falls in: ``layers.<i>`` for a list entry,
    ``embed`` for the embedding, else ``head``."""
    parts = name.split(".")
    if len(parts) > 1 and parts[1].isdigit():
        return ".".join(parts[:2])
    return EMBED_KEY if parts[0] == EMBED_KEY else HEAD_UNIT


def build_units(named_shapes: Sequence[Tuple[str, Sequence[int]]], world: int) -> List[Unit]:
    """The flat units of a parameter tree over ``world`` ranks: the
    embedding's, one a list entry (a layer) in order, the head's; each
    unit's leaves in the tree's flatten order."""
    groups: Dict[str, List[Tuple[str, Tuple[int, ...]]]] = {}
    for name, shape in named_shapes:
        groups.setdefault(unit_key(name), []).append((name, tuple(shape)))
    order = sorted(groups, key=lambda k: (k != EMBED_KEY, k == HEAD_UNIT,
                                          int(k.split(".")[1]) if "." in k else 0,
                                          k.split(".")[0]))
    units = []
    for key in order:
        leaves = groups[key]
        offsets, pos = [], 0
        for _, shape in leaves:
            offsets.append(pos)
            pos = _round_up(pos + math.prod(shape), FLAT_ALIGN)
        padded = _round_up(max(pos, 1), world * FLAT_ALIGN)
        units.append(Unit(key, [n for n, _ in leaves], [s for _, s in leaves], offsets,
                          padded, padded // world))
    return units


def held_elements(units: Sequence[Unit], stage: int, rules: Optional[ZeroShardingRules] = None
                  ) -> Dict[str, int]:
    """Elements a rank holds of each kind of state at ``stage`` (the
    reckoning of the ``zero`` phase): ``params`` (compute params outside a
    gather window), ``master`` (fp32 masters and each optimizer moment),
    ``grads`` (the accumulation buffer)."""
    full = sum(u.padded for u in units)
    part = sum(u.block for u in units)
    if stage >= 3 and rules is not None:
        params = sum(u.block if rules.params_partitioned(u.numel) else u.padded for u in units)
    else:
        params = part if stage >= 3 else full
    return {"params": params, "master": part if stage >= 1 else full,
            "grads": part if stage >= 2 else full}


__all__ = ["FLAT_ALIGN", "EMBED_KEY", "HEAD_UNIT", "ZeroShardingRules", "Unit", "Segment",
           "build_units", "unit_key",
           "held_elements", "_partition_axes"]
