"""Accelerator abstraction (the port's counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``): the surface callers
use instead of a hard-coded backend. Devices are ``torch.device``s, RNG is a
``torch.Generator``, memory stats come from the CUDA caching allocator, and
the device's peak rates live here (the roofline and MFU denominators).

Host syncs go through the accelerator so they can be counted:
:meth:`DeepSpeedAccelerator.synchronize` and :meth:`DeepSpeedAccelerator.to_host`
(a blocking device read) add one to the module's ``syncs`` counter (a plain
int; set it to 0 before a run, read it after)."""

from __future__ import annotations

import abc

#: synchronize() calls and to_host() reads, on any accelerator
syncs = 0


class DeepSpeedAccelerator(abc.ABC):

    def __init__(self):
        self._name = None
        self._communication_backend_name = None

    @abc.abstractmethod
    def device(self, device_index: int = 0):
        """The ``torch.device`` of local device ``device_index``."""

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    def synchronize(self) -> None:
        """Wait for the device's queued work (counted in ``syncs``)."""
        global syncs
        syncs += 1
        self._synchronize()

    @abc.abstractmethod
    def _synchronize(self) -> None:
        ...

    def to_host(self, tensor):
        """``tensor`` on the host: a blocking device read of a device
        tensor (counted in ``syncs``, on the CPU too, so the tests see the
        same count as the card)."""
        global syncs
        syncs += 1
        return tensor.detach().cpu()

    def range_push(self, name: str) -> None:
        """Open a named range on the device profiler's timeline."""

    def range_pop(self) -> None:
        """Close the innermost :meth:`range_push` range."""

    @abc.abstractmethod
    def default_generator(self, seed: int = 0):
        """A ``torch.Generator`` on this accelerator, seeded with ``seed``."""

    @abc.abstractmethod
    def max_memory_allocated(self) -> int:
        ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self) -> None:
        ...

    @abc.abstractmethod
    def memory_report(self) -> dict:
        """``{device_name: {bytes_in_use, peak_bytes_in_use, bytes_limit,
        headroom_bytes}}``; an empty dict for a device without stats."""

    @abc.abstractmethod
    def peak_tflops(self) -> float:
        """Dense bf16 peak TFLOP/s of one device, 0.0 when unknown
        (``DS_PEAK_TFLOPS`` overrides it, as in the JAX package)."""

    @abc.abstractmethod
    def memory_bandwidth(self) -> float:
        """Device-memory bandwidth in bytes/s, 0.0 when unknown."""

    @abc.abstractmethod
    def preferred_dtype(self):
        ...

    def communication_backend_name(self) -> str:
        return self._communication_backend_name
