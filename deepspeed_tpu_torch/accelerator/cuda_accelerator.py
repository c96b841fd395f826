"""CUDA accelerator (the port's counterpart of
``deepspeed_tpu/accelerator/tpu_accelerator.py``), plus the CPU one the
tests use."""

from __future__ import annotations

import os

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):

    # dense bf16 tensor-core peak (TFLOP/s) and HBM bandwidth (bytes/s) by
    # device name, from NVIDIA's data sheets (SXM parts at 700 W). A card
    # set below 700 W runs slower under load: report its power limit beside
    # any share of these.
    _PEAKS = (("h100", 989.0, 3.35e12), ("h200", 989.0, 4.8e12))

    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def device(self, device_index: int = 0):
        return torch.device("cuda", device_index)

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def _synchronize(self) -> None:
        torch.cuda.synchronize()

    def range_push(self, name: str) -> None:
        torch.cuda.nvtx.range_push(name)

    def range_pop(self) -> None:
        torch.cuda.nvtx.range_pop()

    def default_generator(self, seed: int = 0):
        return torch.Generator(device=self.device()).manual_seed(int(seed))

    def max_memory_allocated(self) -> int:
        return torch.cuda.max_memory_allocated()

    def reset_peak_memory_stats(self) -> None:
        torch.cuda.reset_peak_memory_stats()

    def memory_report(self) -> dict:
        out = {}
        for i in range(self.device_count()):
            used = torch.cuda.memory_allocated(i)
            limit = torch.cuda.get_device_properties(i).total_memory
            out[f"cuda:{i}"] = {
                "bytes_in_use": used,
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_limit": limit,
                "headroom_bytes": max(limit - used, 0),
            }
        return out

    def _peak(self):
        name = torch.cuda.get_device_name(0).lower().replace(" ", "")
        for tag, tflops, bw in self._PEAKS:
            if tag in name:
                return tflops, bw
        return 0.0, 0.0

    def peak_tflops(self) -> float:
        env = os.environ.get("DS_PEAK_TFLOPS")
        if env:
            return float(env)
        return self._peak()[0]

    def memory_bandwidth(self) -> float:
        return self._peak()[1]

    def preferred_dtype(self):
        return torch.bfloat16


class CPU_Accelerator(DeepSpeedAccelerator):
    """The host CPU: where the tests run the kernels' plain versions. It has
    no device-memory stats and no published peak, so those read as empty
    and 0.0 rather than fabricated numbers."""

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def device(self, device_index: int = 0):
        return torch.device("cpu")

    def device_count(self) -> int:
        return 1

    def _synchronize(self) -> None:
        pass

    def default_generator(self, seed: int = 0):
        return torch.Generator().manual_seed(int(seed))

    def max_memory_allocated(self) -> int:
        return 0

    def reset_peak_memory_stats(self) -> None:
        pass

    def memory_report(self) -> dict:
        return {"cpu": {}}

    def peak_tflops(self) -> float:
        env = os.environ.get("DS_PEAK_TFLOPS")
        return float(env) if env else 0.0

    def memory_bandwidth(self) -> float:
        return 0.0

    def preferred_dtype(self):
        return torch.float32
