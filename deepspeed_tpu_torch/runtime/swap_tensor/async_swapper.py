"""Async NVMe tensor swapper, the counterpart of
``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``: a keyed store of
host tensors streamed to and from a fast local disk through the host
library's aio engine, with a pool of aligned buffers so steady-state
swapping allocates nothing. Tensors are CPU torch tensors; each key is one
file, ``<swap_dir>/<key>.swp``."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, aligned_tensor, padded_numel
from deepspeed_tpu_torch.utils.logging import logger


class AsyncTensorSwapper:
    """Swap named host tensors out to ``swap_dir`` and back, asynchronously:
    ``swap_out`` / ``swap_in`` submit I/O on the aio thread pool and
    :meth:`wait` (or a synchronous call) is the barrier. Buffers are aligned
    and padded so transfers take O_DIRECT."""

    def __init__(self, swap_dir: str, aio_handle: Optional[AsyncIOHandle] = None,
                 block_size: int = 1 << 20, thread_count: int = 8):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.aio = aio_handle or AsyncIOHandle(block_size=block_size, thread_count=thread_count)
        self._meta: Dict[str, Tuple[int, torch.dtype]] = {}     # key -> (numel, dtype)
        # free aligned buffers by (padded numel, dtype)
        self._pool: Dict[Tuple[int, torch.dtype], list] = defaultdict(list)
        # staged swap-out buffers, pooled once their writes complete
        self._inflight_buffers: list = []
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, f"{key}.swp")

    def _get_buffer(self, numel: int, dtype) -> torch.Tensor:
        pkey = (padded_numel(numel, dtype), dtype)
        if self._pool[pkey]:
            return self._pool[pkey].pop()
        return aligned_tensor(numel, dtype)

    def release_buffer(self, buf: torch.Tensor) -> None:
        self._pool[(buf.numel(), buf.dtype)].append(buf)

    # ------------------------------------------------------------------ #
    def swap_out(self, key: str, tensor: torch.Tensor, async_op: bool = False) -> None:
        """Write ``tensor`` under ``key``. The data is staged into an aligned
        buffer, so ``tensor`` may be reused at once."""
        numel = tensor.numel()
        buf = self._get_buffer(numel, tensor.dtype)
        buf[:numel].copy_(tensor.reshape(-1))
        self._meta[key] = (numel, tensor.dtype)
        self.aio.async_pwrite(buf, self._path(key))
        self.swap_out_bytes += buf.numel() * buf.element_size()
        self._inflight_buffers.append(buf)
        if not async_op:
            self.wait()

    def swap_in(self, key: str, out: Optional[torch.Tensor] = None,
                async_op: bool = False) -> torch.Tensor:
        """Read ``key`` back into ``out`` (default a pooled buffer) and return
        the padded aligned buffer; the tensor is ``result[:numel]``. With
        ``async_op`` the caller must :meth:`wait` before touching it."""
        if key not in self._meta:
            raise KeyError(f"no swapped tensor under key '{key}'")
        numel, dtype = self._meta[key]
        buf = out if out is not None else self._get_buffer(numel, dtype)
        self.aio.async_pread(buf, self._path(key))
        self.swap_in_bytes += buf.numel() * buf.element_size()
        if not async_op:
            self.wait()
        return buf

    def write_back(self, key: str, buf: torch.Tensor, async_op: bool = True) -> None:
        """Write a swapped-in aligned buffer back under its key without
        restaging; the buffer is pooled once the write completes."""
        if key not in self._meta:
            raise KeyError(f"no swapped tensor under key '{key}'")
        self.aio.async_pwrite(buf, self._path(key))
        self.swap_out_bytes += buf.numel() * buf.element_size()
        self._inflight_buffers.append(buf)
        if not async_op:
            self.wait()

    def numel(self, key: str) -> int:
        return self._meta[key][0]

    def contains(self, key: str) -> bool:
        return key in self._meta

    def wait(self) -> None:
        self.aio.wait()
        for buf in self._inflight_buffers:
            self.release_buffer(buf)
        self._inflight_buffers.clear()

    def remove(self, key: str) -> None:
        if self._meta.pop(key, None) is not None:
            try:
                os.unlink(self._path(key))
            except OSError:
                logger.warning(f"could not remove swap file for {key}")
