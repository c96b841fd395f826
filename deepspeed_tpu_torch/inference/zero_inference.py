"""ZeRO-Inference's layer bytes: how one layer's weights sit in one
contiguous byte range, so a layer crosses to the card as ONE copy (and is
read from NVMe as one file), and how the card's layer buffers are viewed
back as the layer tree that ``models/transformer.cached_block`` reads.

Every layer of a zoo model has the same leaves, so one :class:`LayerLayout`
serves all of them. Leaves start at 256-byte offsets in the layer's dict
order; an int8 ``Quantized8`` leaf is two entries, its payload and its
fp32 scales, rebuilt as a ``Quantized8`` over the two views. A layer's
stride rounds its bytes up to 4096, the O_DIRECT block, so layer ``i`` of a
host slab starts at ``i * stride`` and an NVMe read of it is aligned.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from deepspeed_tpu_torch.ops.aio import ALIGN
from deepspeed_tpu_torch.ops.quant import Quantized8

_LEAF_ALIGN = 256


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class LayerLayout:
    """The byte layout of one layer tree (nested dict of tensors and
    ``Quantized8`` leaves)."""

    def __init__(self, layer: Dict[str, Any]):
        self.entries: List[Tuple[tuple, Any, tuple, torch.dtype, int]] = []
        off = 0
        for path, leaf in _walk(layer):
            parts = ([("q", leaf.q), ("scale", leaf.scale)] if isinstance(leaf, Quantized8)
                     else [(None, leaf)])
            for field, t in parts:
                off = _align(off, _LEAF_ALIGN)
                self.entries.append((path, field, tuple(t.shape), t.dtype, off))
                off += t.numel() * t.element_size()
        self.nbytes = off
        self.stride = _align(off, ALIGN)

    def _views(self, buf: torch.Tensor):
        for path, field, shape, dtype, off in self.entries:
            n = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
            yield path, field, buf[off:off + n].view(dtype).view(shape)

    def pack(self, layer: Dict[str, Any], dst: torch.Tensor) -> None:
        """Copy ``layer``'s leaves into the uint8 bytes ``dst``."""
        leaves = dict(_walk(layer))
        with torch.no_grad():
            for path, field, view in self._views(dst):
                leaf = leaves[path]
                view.copy_(getattr(leaf, field).data if field else leaf)

    def unpack(self, src: torch.Tensor) -> Dict[str, Any]:
        """The layer tree as views of the uint8 bytes ``src``."""
        tree: Dict[str, Any] = {}
        qparts: Dict[tuple, Dict[str, torch.Tensor]] = {}
        for path, field, view in self._views(src):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            if field is None:
                node[path[-1]] = view
            else:
                qparts.setdefault(path, {})[field] = view
                if len(qparts[path]) == 2:
                    node[path[-1]] = Quantized8(qparts[path]["q"], qparts[path]["scale"])
        return tree
