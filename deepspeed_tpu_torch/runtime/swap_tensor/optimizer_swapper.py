"""NVMe swapping of optimizer state around the host optimizer step, the
counterpart of ``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``:
fp32 masters and moments live on disk; each partition is swapped in,
stepped, and swapped back out, with the next partition's reads overlapped
behind the current step."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper


class PartitionedOptimizerSwapper:
    """Per-partition optimizer tensors (fp32 master and states) on NVMe;
    :meth:`step_all` runs swap-in, step and swap-out over every partition
    with one partition of read-ahead."""

    def __init__(self, swap_dir: str, aio_config: Optional[dict] = None,
                 state_keys=("master", "exp_avg", "exp_avg_sq")):
        aio_config = aio_config or {}
        self.STATE_KEYS = tuple(state_keys)
        self.swapper = AsyncTensorSwapper(swap_dir,
                                          block_size=aio_config.get("block_size", 1 << 20),
                                          thread_count=aio_config.get("thread_count", 8))
        self._numels: Dict[str, int] = {}

    def register_partition(self, key: str, master_fp32: torch.Tensor) -> None:
        """Initial placement: the master and zero moments written to disk."""
        n = master_fp32.numel()
        self._numels[key] = n
        self.swapper.swap_out(f"{key}.master", master_fp32.float(), async_op=True)
        zeros = torch.zeros(n, dtype=torch.float32)
        for s in self.STATE_KEYS:
            if s != "master":
                self.swapper.swap_out(f"{key}.{s}", zeros, async_op=True)
        self.swapper.wait()

    def partitions(self) -> List[str]:
        return sorted(self._numels)

    def _swap_in_states(self, key: str, async_op: bool) -> Dict[str, torch.Tensor]:
        return {s: self.swapper.swap_in(f"{key}.{s}", async_op=async_op)
                for s in self.STATE_KEYS}

    def step_all(self, step_fn: Callable[[str, int, Dict[str, torch.Tensor]], None]) -> None:
        """``step_fn(key, numel, states)`` updates ``states`` in place (padded
        aligned buffers; the data is ``states[s][:numel]``). Partition i+1's
        reads overlap partition i's step."""
        keys = self.partitions()
        if not keys:
            return
        current = self._swap_in_states(keys[0], async_op=False)
        for i, key in enumerate(keys):
            nxt = self._swap_in_states(keys[i + 1], async_op=True) if i + 1 < len(keys) else None
            step_fn(key, self._numels[key], current)
            # write the states back; the barrier also completes the
            # prefetched reads of the next partition
            for s in self.STATE_KEYS:
                self.swapper.write_back(f"{key}.{s}", current[s])
            self.swapper.wait()
            if nxt is not None:
                current = nxt

    def read_state(self, key: str, state: str = "master") -> torch.Tensor:
        buf = self.swapper.swap_in(f"{key}.{state}")
        out = buf[:self._numels[key]].clone()
        self.swapper.release_buffer(buf)
        return out

    def write_state(self, key: str, state: str, value) -> None:
        self.swapper.swap_out(f"{key}.{state}",
                              torch.as_tensor(value, dtype=torch.float32).reshape(-1))

    def read_master(self, key: str) -> torch.Tensor:
        return self.read_state(key, "master")
