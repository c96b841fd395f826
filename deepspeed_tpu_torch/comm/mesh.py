"""Named-axis meshes over the world's ranks (counterpart of
``deepspeed_tpu/comm/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` with named axes and
addresses every collective by axis name. The port keeps that model over
``torch.distributed``: a :class:`Mesh` is a grid of global ranks with one
dimension per axis, in the same canonical order (outer -> inner
``("pp", "dp", "fsdp", "ep", "tp", "sp")``) and with the same ``-1`` rule.
A group is an axis or a tuple of axes; the ranks of a group are the mesh
slice through the calling rank along those axes, and ``comm`` creates one
``torch.distributed`` process group per slice the first time a group is
used (every rank takes part, as ``new_group`` requires).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

# outer -> inner; pp outermost (least communication), tp/sp innermost (most)
CANONICAL_AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "tp", "sp")


class Mesh:
    """A grid of global ranks, one dimension per named axis. ``shape`` maps
    each axis to its size in mesh order, as ``jax.sharding.Mesh.shape``
    does."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a {self.ranks.ndim}-d rank grid for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.ranks.shape))
        # axes tuple -> (process group or None, members in group order)
        self.groups: Dict[Tuple[str, ...], tuple] = {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s coordinate on every axis."""
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def slices(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every slice of the mesh along ``axes``: the ranks of each, in
        group order (row-major over ``axes`` as given), the slices ordered
        by the coordinates of the other axes."""
        rest = [a for a in self.axis_names if a not in axes]
        order = [self.axis_names.index(a) for a in rest + list(axes)]
        grid = self.ranks.transpose(order).reshape(-1, math.prod(self.shape[a] for a in axes))
        return [[int(r) for r in row] for row in grid]

    def slice_of(self, axes: Tuple[str, ...], rank: int) -> List[int]:
        """The ranks of ``rank``'s slice along ``axes``, in group order."""
        return next(s for s in self.slices(axes) if rank in s)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _resolve_axis_sizes(axes: Dict[str, int], n_devices: int) -> Dict[str, int]:
    """Fill in a single ``-1`` axis so the product equals ``n_devices``."""
    sizes = dict(axes)
    wildcard = [name for name, size in sizes.items() if size == -1]
    if len(wildcard) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {wildcard}")
    known = math.prod(size for size in sizes.values() if size != -1)
    if wildcard:
        if n_devices % known != 0:
            raise ValueError(f"Device count {n_devices} not divisible by fixed axes product {known}")
        sizes[wildcard[0]] = n_devices // known
    else:
        if known != n_devices:
            raise ValueError(f"Mesh axes product {known} != device count {n_devices}")
    return sizes


def _world_ranks() -> List[int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def build_mesh(axes: Optional[Dict[str, int]] = None,
               ranks: Optional[Sequence[int]] = None,
               axis_order: Sequence[str] = CANONICAL_AXIS_ORDER) -> Mesh:
    """A named-axis mesh over ``ranks`` (default: every rank of the world).

    ``axes`` maps axis name -> size, with at most one ``-1`` meaning "all
    remaining ranks"; default ``{"dp": -1}``. The declared axes are laid out
    in canonical order, unknown axes innermost, over the ranks in order."""
    ranks = _world_ranks() if ranks is None else [int(r) for r in ranks]
    if axes is None:
        axes = {"dp": -1}
    sizes = _resolve_axis_sizes(axes, len(ranks))
    names = sorted(sizes, key=lambda n: axis_order.index(n) if n in axis_order else len(axis_order))
    shape = tuple(sizes[n] for n in names)
    mesh = Mesh(np.array(ranks).reshape(shape), names)
    logger.info(f"Built rank mesh {dict(zip(names, shape))} over {len(ranks)} ranks")
    return mesh


def build_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int]) -> Mesh:
    """A multi-node mesh: per axis, ``dcn_axes[name]`` replicas span nodes
    and ``ici_axes[name]`` ranks span within a node (the ranks of a node are
    consecutive, as the launcher numbers them). Both dicts name the same
    axes; an axis's size is the product, its node index the outer factor,
    as ``mesh_utils.create_hybrid_device_mesh`` lays out the JAX mesh::

        build_hybrid_mesh(ici_axes={"dp": 1, "tp": 8}, dcn_axes={"dp": 2, "tp": 1})
        # -> Mesh {"dp": 2, "tp": 8}, dp across the 2 nodes, tp within each
    """
    if set(ici_axes) != set(dcn_axes):
        raise ValueError(f"ici_axes and dcn_axes must name the same axes, got {set(ici_axes)} "
                         f"vs {set(dcn_axes)}")
    names = [n for n in CANONICAL_AXIS_ORDER if n in ici_axes] + \
            [n for n in ici_axes if n not in CANONICAL_AXIS_ORDER]
    ici = [ici_axes[n] for n in names]
    dcn = [dcn_axes[n] for n in names]
    world = _world_ranks()
    if math.prod(ici) * math.prod(dcn) != len(world):
        raise ValueError(f"ici {ici} x dcn {dcn} != world size {len(world)}")
    k = len(names)
    # [dcn..., ici...] -> interleave each axis's (dcn, ici) pair -> merge
    grid = np.array(world).reshape(dcn + ici)
    grid = grid.transpose([j for i in range(k) for j in (i, k + i)])
    return Mesh(grid.reshape([d * i for d, i in zip(dcn, ici)]), names)


def axis_size(mesh: Mesh, axis) -> int:
    """Product of sizes of (possibly multiple) mesh axes."""
    if axis is None:
        return math.prod(mesh.shape.values())
    if isinstance(axis, str):
        return mesh.shape[axis] if axis in mesh.shape else 1
    return math.prod(mesh.shape[a] for a in axis if a in mesh.shape)


def data_parallel_axes(mesh: Mesh) -> List[str]:
    """Axes over which the batch is sharded (dp + fsdp when present)."""
    return [ax for ax in ("dp", "fsdp") if ax in mesh.shape and mesh.shape[ax] > 1] or \
           [ax for ax in ("dp", "fsdp") if ax in mesh.shape]
