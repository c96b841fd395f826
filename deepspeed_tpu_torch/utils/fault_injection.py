"""Deterministic storage fault injection for the checkpoint writer (the
write faults of ``deepspeed_tpu/utils/fault_injection.py``).

The crash-safe writer (``runtime/checkpoint_engine/safe_engine``) routes
every byte it persists through :func:`guarded_write`. With no injector
installed that is one ``None`` check; under an installed
:class:`FaultInjector`:

- **kill mid-write** (``kill_at_byte=N``): the process "dies" after exactly
  ``N`` bytes have reached storage — the file is truncated there and
  :class:`SimulatedCrash` propagates; nothing after the kill point runs;
- **transient / persistent I/O errors** (:meth:`FaultInjector.fail_writes`):
  ``OSError(ENOSPC)`` / ``OSError(EIO)`` for the first ``count`` matching
  writes (``count < 0``: forever);
- **delayed writes** (``delay_per_write_s``);
- **bit-flip corruption** (:func:`bit_flip`) of an already-committed file.

``SimulatedCrash`` subclasses ``BaseException`` so that retry loops catching
``Exception`` / ``OSError`` never "survive" a crash. The serving step faults
and the KV cache's ``guarded_io`` come with fault containment and the
tiered KV cache (ROADMAP.md queue 1).

    from deepspeed_tpu_torch.utils import fault_injection as fi

    with fi.inject(fi.FaultInjector(kill_at_byte=4096)):
        engine.save_checkpoint(d)        # raises fi.SimulatedCrash

    fi.bit_flip(os.path.join(tag_dir, "state.npz"))
"""

from __future__ import annotations

import contextlib
import errno as _errno
import os
import threading
import time
from typing import List, Optional

__all__ = [
    "SimulatedCrash", "FaultInjector", "install", "clear", "active",
    "inject", "guarded_write", "bit_flip",
]


class SimulatedCrash(BaseException):
    """The injected process death. BaseException so ``except Exception``
    retry/cleanup paths cannot accidentally swallow it."""


class _WriteFault:
    """One scheduled OSError: fires for up to ``count`` writes whose path
    contains ``path_substr`` (empty matches everything)."""

    def __init__(self, errno: int, path_substr: str = "", count: int = 1):
        self.errno = errno
        self.path_substr = path_substr
        self.count = count


class FaultInjector:
    """Deterministic write-path fault plan. Thread-safe: the async
    checkpoint writer hits it from its own thread."""

    def __init__(self, kill_at_byte: Optional[int] = None,
                 delay_per_write_s: float = 0.0):
        self.kill_at_byte = kill_at_byte
        self.delay_per_write_s = delay_per_write_s
        self._faults: List[_WriteFault] = []
        self._lock = threading.Lock()
        self.bytes_seen = 0          # cumulative bytes offered to storage
        self.writes_seen = 0
        self.crashed = False

    def fail_writes(self, errno_code: int = _errno.ENOSPC,
                    path_substr: str = "", count: int = 1) -> "FaultInjector":
        """Schedule ``count`` matching writes to raise ``OSError(errno)``.
        ``count < 0`` means every matching write fails forever (a persistent
        fault that outlives any retry budget). Returns self for chaining."""
        self._faults.append(_WriteFault(errno_code, path_substr, count))
        return self

    def on_write(self, path: str, size: int) -> int:
        """Called by :func:`guarded_write` before ``size`` bytes go to
        ``path``. Returns how many bytes may be written; raising ``OSError``
        models an I/O fault. A return < size means the crash point lies
        inside this write: the caller persists exactly that prefix, then
        :func:`guarded_write` raises :class:`SimulatedCrash`."""
        if self.delay_per_write_s > 0.0:
            time.sleep(self.delay_per_write_s)
        with self._lock:
            self.writes_seen += 1
            for f in self._faults:
                if f.count != 0 and f.path_substr in path:
                    if f.count > 0:
                        f.count -= 1
                    raise OSError(f.errno, os.strerror(f.errno), path)
            if self.kill_at_byte is not None:
                remaining = self.kill_at_byte - self.bytes_seen
                if remaining < size:
                    self.bytes_seen = self.kill_at_byte
                    self.crashed = True
                    return max(remaining, 0)
            self.bytes_seen += size
        return size


_active: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _active
    _active = injector
    return injector


def clear() -> None:
    global _active
    _active = None


def active() -> Optional[FaultInjector]:
    return _active


@contextlib.contextmanager
def inject(injector: FaultInjector):
    """``with fi.inject(FaultInjector(...)):`` — installed for the block."""
    install(injector)
    try:
        yield injector
    finally:
        clear()


def guarded_write(fileobj, data, path: str) -> None:
    """The checkpoint writer's single byte sink. No injector: one ``None``
    check and a plain ``write``. Injector: faults may fire; on a kill point
    the allowed prefix is flushed to disk (so the truncated file is really
    there, like after power loss) before :class:`SimulatedCrash` raises."""
    inj = _active
    if inj is None:
        fileobj.write(data)
        return
    view = memoryview(data) if not isinstance(data, memoryview) else data
    allowed = inj.on_write(path, view.nbytes)
    if allowed < view.nbytes:
        if allowed:
            fileobj.write(view.cast("B")[:allowed])
        try:
            fileobj.flush()
            os.fsync(fileobj.fileno())
        except (OSError, ValueError):
            pass
        raise SimulatedCrash(
            f"simulated crash after {inj.kill_at_byte} bytes (in {path})")
    fileobj.write(view)


def bit_flip(path: str, byte_index: Optional[int] = None, bit: int = 0) -> int:
    """Flip one bit of an existing file in place (default: the middle
    byte). Returns the byte index flipped. Deterministic corruption for
    manifest-verification tests."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bit-flip empty file {path}")
    idx = size // 2 if byte_index is None else byte_index
    if not 0 <= idx < size:
        raise ValueError(f"byte_index {idx} out of range for {path} ({size}B)")
    with open(path, "r+b") as f:
        f.seek(idx)
        b = f.read(1)
        f.seek(idx)
        f.write(bytes([b[0] ^ (1 << bit)]))
        f.flush()
        os.fsync(f.fileno())
    return idx
