"""Accelerator selection (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``): the CUDA accelerator,
or the CPU one when asked for by name or by ``DS_ACCELERATOR=cpu``. Asking
for CUDA without a CUDA device raises: the port never falls back to the
CPU on its own."""

from __future__ import annotations

import os
from typing import Optional

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CPU_Accelerator, CUDA_Accelerator


def get_accelerator(name: Optional[str] = None) -> DeepSpeedAccelerator:
    name = name or os.environ.get("DS_ACCELERATOR", "cuda")
    if name == "cpu":
        return CPU_Accelerator()
    if name != "cuda":
        raise ValueError(f"unknown accelerator {name!r} (expected cuda | cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: deepspeed_tpu_torch runs on an NVIDIA "
                           "GPU; pass device='cpu' to run the kernels' plain versions")
    return CUDA_Accelerator()


def default_accelerator() -> DeepSpeedAccelerator:
    """For host-side tools that serve no engine (span ranges, timers,
    memory gauges): the CUDA accelerator when a device is there, else the
    CPU's."""
    try:
        return get_accelerator()
    except RuntimeError:
        return get_accelerator("cpu")


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` -> ``cuda:0``, raising without a
    CUDA device; the CPU only when asked for (the tests run the kernels'
    plain versions there)."""
    if device is None:
        return get_accelerator("cuda").device(0)
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    get_accelerator(dev.type)        # raises for cuda without a CUDA device
    return dev
