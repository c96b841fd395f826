"""ctypes bindings of the host library's async I/O engine
(``csrc/host/aio.cpp``), the counterpart of
``deepspeed_tpu/ops/aio/aio_binding.py``, plus the aligned host buffers it
reads into.

The engine splits each request into ``block_size`` chunks served by a
thread pool with pread / pwrite, and takes O_DIRECT when the buffer, the
offset and the size are 4096-byte aligned (else the page cache).
:func:`aligned_tensor` and :class:`HostSlab` give such buffers as torch
tensors; a :class:`HostSlab` can also be pinned for the card with
``cudaHostRegister``, at its exact size (the caching host allocator behind
``pin_memory=True`` rounds a request up to a power of two), so an NVMe
read lands straight in memory the card copies from.
"""

from __future__ import annotations

import os
import weakref

import torch

from deepspeed_tpu_torch.ops import native

ALIGN = 4096


def padded_numel(numel: int, dtype=torch.float32) -> int:
    """Element count after padding to the O_DIRECT block size."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = numel * itemsize
    return ((nbytes + ALIGN - 1) // ALIGN * ALIGN) // itemsize


def aligned_tensor(numel: int, dtype=torch.float32) -> torch.Tensor:
    """A zeroed 4096-byte-aligned tensor of ``padded_numel(numel)``
    elements: callers view ``[:numel]`` and hand the whole tensor to the
    engine, so transfers stay block-aligned."""
    n = padded_numel(numel, dtype)
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    raw = torch.zeros(nbytes + ALIGN, dtype=torch.uint8)
    offset = (-raw.data_ptr()) % ALIGN
    return raw[offset:offset + nbytes].view(dtype)


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


class HostSlab:
    """``nbytes`` of 4096-aligned host memory as a uint8 tensor
    (``.bytes``), uninitialised, pinned for the card when ``pin`` (exactly
    these bytes, through ``cudaHostRegister``). The registration is undone
    when the slab is collected; callers synchronize their copies first."""

    def __init__(self, nbytes: int, pin: bool = False):
        raw = torch.empty(int(nbytes) + ALIGN, dtype=torch.uint8)
        offset = (-raw.data_ptr()) % ALIGN
        self.bytes = raw[offset:offset + int(nbytes)]
        self.nbytes = int(nbytes)
        self._raw = raw
        self.pinned = False
        if pin and nbytes:
            ptr = self.bytes.data_ptr()
            err = int(torch.cuda.cudart().cudaHostRegister(ptr, self.nbytes, 0))
            if err:
                raise RuntimeError(f"cudaHostRegister of {self.nbytes} bytes failed "
                                   f"(cudaError {err})")
            self.pinned = True
            # runs before the slab's attributes go, so while raw is alive
            weakref.finalize(self, _unregister, ptr).atexit = False


class AsyncIOHandle:
    """Thread-pool async tensor I/O against a fast local disk. Buffers are
    numpy arrays or CPU torch tensors, kept referenced until :meth:`wait`."""

    def __init__(self, block_size: int = 1 << 20, thread_count: int = 8):
        self.block_size = block_size
        self.thread_count = thread_count
        self._lib = native.get_lib()
        self._h = self._lib.ds_aio_handle_new(block_size, thread_count)
        self._pinned: list = []  # buffers referenced by inflight C++ I/O

    def close(self) -> None:
        """Wait for the inflight I/O and free the engine's threads."""
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ds_aio_wait(h)
            self._lib.ds_aio_handle_free(h)
        self._pinned = []

    def __del__(self):
        self.close()

    # --- async ---------------------------------------------------------- #
    def async_pread(self, buffer, filename: str) -> None:
        ptr = native.buffer_ptr(buffer, "bytes", "aio buffer")
        self._pinned.append(buffer)     # worker threads hold the raw pointer
        self._lib.ds_aio_pread(self._h, ptr, filename.encode(), native.nbytes(buffer))

    def async_pwrite(self, buffer, filename: str) -> None:
        ptr = native.buffer_ptr(buffer, "bytes", "aio buffer")
        self._pinned.append(buffer)
        self._lib.ds_aio_pwrite(self._h, ptr, filename.encode(), native.nbytes(buffer))

    def wait(self) -> int:
        """Block until all inflight I/O completes; raises on I/O errors."""
        errors = self._lib.ds_aio_wait(self._h)
        self._pinned.clear()
        if errors:
            err = self._lib.ds_aio_last_errno(self._h)
            detail = f": {os.strerror(err)}" if err else ""
            raise IOError(f"aio: {errors} chunk transfer(s) failed{detail}")
        return 0

    def inflight(self) -> int:
        return self._lib.ds_aio_inflight(self._h)

    # --- sync ----------------------------------------------------------- #
    def sync_pread(self, buffer, filename: str) -> None:
        self.async_pread(buffer, filename)
        self.wait()

    def sync_pwrite(self, buffer, filename: str) -> None:
        self.async_pwrite(buffer, filename)
        self.wait()
