"""NVMe swapping of parameter partitions, the counterpart of
``deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py``:
partitions stream between disk and aligned host buffers, a prefetch
hiding the read behind other work."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper


class AsyncPartitionedParameterSwapper:
    def __init__(self, swap_dir: str, aio_config: Optional[dict] = None):
        aio_config = aio_config or {}
        self.swapper = AsyncTensorSwapper(swap_dir,
                                          block_size=aio_config.get("block_size", 1 << 20),
                                          thread_count=aio_config.get("thread_count", 8))
        self._available: Dict[str, torch.Tensor] = {}   # key -> padded host buffer
        self._prefetching: Dict[str, torch.Tensor] = {}

    def swap_out_and_release(self, key: str, tensor: torch.Tensor) -> None:
        """Persist a partition to disk and drop its host buffer."""
        self.swapper.swap_out(key, tensor, async_op=True)
        self._available.pop(key, None)

    def prefetch(self, key: str) -> None:
        """Start an async read; :meth:`get` picks it up."""
        if key in self._available or key in self._prefetching:
            return
        self._prefetching[key] = self.swapper.swap_in(key, async_op=True)

    def get(self, key: str) -> torch.Tensor:
        """The tensor under ``key``, waiting on (or issuing) its read."""
        if key not in self._available:
            if key not in self._prefetching:
                self.prefetch(key)
            self.wait()
        return self._available[key][:self.swapper.numel(key)]

    def release(self, key: str) -> None:
        buf = self._available.pop(key, None)
        if buf is not None:
            self.swapper.release_buffer(buf)

    def available_keys(self) -> List[str]:
        return sorted(self._available)

    def wait(self) -> None:
        self.swapper.wait()
        self._available.update(self._prefetching)
        self._prefetching.clear()
