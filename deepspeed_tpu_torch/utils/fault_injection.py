"""Deterministic fault injection for the checkpoint writer and the serving
loop (the write and step faults of ``deepspeed_tpu/utils/fault_injection.py``).

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
- **bit-flip corruption** (:func:`bit_flip`) of an already-committed file;
- **serving step faults** (:meth:`FaultInjector.fail_step`): the paged
  serving session consults :func:`step_fault` at each dispatch site, so a
  scheduled fault fires before a forward (``phase="pre"``, contained per
  request) or after it with the pools left unadopted (``phase="post"``,
  engine-fatal), and ``delay_per_step_s`` slows every action.

- **host KV tier transfers**: the tiered KV cache's spill (D2H) and fetch
  (H2D) copies consult :func:`guarded_io` under the virtual paths
  ``kv_host_pool/spill`` and ``kv_host_pool/fetch``, so ``fail_writes``
  faults fire there too (the pool degrades) and the kill-at-byte plan
  counts their bytes.

``SimulatedCrash`` subclasses ``BaseException`` so that retry loops catching
``Exception`` / ``OSError`` never "survive" a crash.

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
    "inject", "guarded_write", "guarded_io", "step_fault", "bit_flip",
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


class _StepFault:
    """One scheduled serving-step fault: fires for up to ``count`` engine
    actions of ``kind`` (empty matches every kind) in ``phase`` once the
    injector's step counter reaches ``at_step`` (None = immediately).
    JAX: ``deepspeed_tpu/utils/fault_injection.py:81``."""

    def __init__(self, kind: str = "", at_step: Optional[int] = None,
                 count: int = 1, exc=None, phase: str = "pre"):
        if phase not in ("pre", "post"):
            raise ValueError(f"phase must be 'pre' or 'post', got {phase!r}")
        self.kind = kind
        self.at_step = at_step
        self.count = count
        self.exc = exc
        self.phase = phase


class FaultInjector:
    """Deterministic write-path and serving-step fault plan. Thread-safe:
    the async checkpoint writer hits it from its own thread
    (JAX ``fault_injection.py:103``)."""

    def __init__(self, kill_at_byte: Optional[int] = None,
                 delay_per_write_s: float = 0.0,
                 delay_per_step_s: float = 0.0):
        self.kill_at_byte = kill_at_byte
        self.delay_per_write_s = delay_per_write_s
        self.delay_per_step_s = delay_per_step_s
        self._faults: List[_WriteFault] = []
        self._step_faults: List[_StepFault] = []
        self._lock = threading.Lock()
        self.bytes_seen = 0          # cumulative bytes offered to storage
        self.writes_seen = 0
        self.steps_seen = 0          # engine actions observed (pre-phase)
        self.crashed = False

    def fail_writes(self, errno_code: int = _errno.ENOSPC,
                    path_substr: str = "", count: int = 1) -> "FaultInjector":
        """Schedule ``count`` matching writes to raise ``OSError(errno)``.
        ``count < 0`` means every matching write fails forever (a persistent
        fault that outlives any retry budget). Returns self for chaining."""
        self._faults.append(_WriteFault(errno_code, path_substr, count))
        return self

    def fail_step(self, kind: str = "", at_step: Optional[int] = None,
                  count: int = 1, exc=None,
                  phase: str = "pre") -> "FaultInjector":
        """Schedule ``count`` serving engine steps to raise (JAX
        ``fault_injection.py:125``). ``kind`` matches the dispatch site
        (``prefill`` / ``prefill_chunk`` / ``decode`` / ``verify`` /
        ``cow``; empty = any), ``at_step`` pins the firing to the
        injector's engine-action counter (None = the first matching step),
        ``count < 0`` fails every matching step forever. ``exc`` is the
        exception instance (or zero-arg factory) to raise; default
        ``RuntimeError``. ``phase="pre"`` fires before the forward (per
        request containable); ``phase="post"`` fires after it, before the
        session adopts the written pools (engine-fatal). Returns self."""
        self._step_faults.append(_StepFault(kind, at_step, count, exc, phase))
        return self

    def on_step(self, kind: str, phase: str, tick: bool) -> None:
        """Called by :func:`step_fault` at a serving dispatch site (JAX
        ``fault_injection.py:144``). ``tick`` advances the engine-action
        counter (once per scheduler action, at the top-of-executor pre
        consult); sub-action sites and post consults observe without
        ticking, and ``delay_per_step_s`` sleeps once per action. Raises
        the scheduled exception when a fault matches."""
        if self.delay_per_step_s > 0.0 and tick:
            time.sleep(self.delay_per_step_s)
        with self._lock:
            if tick:
                self.steps_seen += 1
            for f in self._step_faults:
                if f.count == 0 or f.phase != phase:
                    continue
                if f.kind and f.kind != kind:
                    continue
                if f.at_step is not None and self.steps_seen < f.at_step:
                    continue
                if f.count > 0:
                    f.count -= 1
                exc = f.exc
                if exc is None:
                    exc = RuntimeError(
                        f"injected {phase}-dispatch step fault "
                        f"({kind}, step {self.steps_seen})")
                elif not isinstance(exc, BaseException):
                    exc = exc()
                raise exc

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


def guarded_io(path: str, nbytes: int) -> None:
    """Fault gate for byte movement that is not a file write (JAX
    ``utils/fault_injection.py:256``): the host KV tier's copies, under
    virtual paths like ``kv_host_pool/spill``. No injector: one ``None``
    check. Installed: :meth:`FaultInjector.fail_writes` faults fire by path
    match (``OSError``, which the caller degrades), and the kill-at-byte
    plan advances; a kill point inside this transfer raises
    :class:`SimulatedCrash`, which callers must not catch."""
    inj = _active
    if inj is None:
        return
    allowed = inj.on_write(path, int(nbytes))
    if allowed < int(nbytes):
        raise SimulatedCrash(
            f"simulated crash after {inj.kill_at_byte} bytes (in {path})")


def step_fault(kind: str, phase: str = "pre", tick: bool = False) -> None:
    """Fault gate for the serving session's action executor (JAX
    ``fault_injection.py:274``). No injector: one ``None`` check.
    Installed: scheduled :meth:`FaultInjector.fail_step` faults fire by
    (kind, phase, step) match, and ``delay_per_step_s`` slows the loop so
    deadline and backpressure behaviour is observable."""
    inj = _active
    if inj is None:
        return
    inj.on_step(kind, phase, tick)


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
