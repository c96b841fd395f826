"""The port's host library: ``csrc/host/`` (``aio.cpp``, ``cpu_adam.cpp``,
``cpu_adagrad.cpp``, C ABI, no torch) built with g++ and loaded through
ctypes, the counterpart of ``deepspeed_tpu/ops/native.py``.

The sources compile, at first use, into one shared library under
``csrc/build/`` with the JAX package's flags (its ``csrc/Makefile``) and
``-fno-math-errno``::

    g++ -O3 -std=c++17 -fPIC -fopenmp -funroll-loops -Wall -fno-math-errno \\
        -march=native -shared aio.cpp cpu_adam.cpp cpu_adagrad.cpp \\
        -o libdstpu_host_<hash>.so -lpthread

retried without ``-march=native`` when the compiler refuses it, with
``$CXX`` first, then ``g++`` and ``c++`` on the PATH and the system's
``/usr/bin/g++`` (a ``$CXX`` set for another build may be a compiler
without OpenMP's runtime files). With
errno semantics GCC keeps ``std::sqrt`` scalar (a call to ``sqrtf`` on the
error path), so the Adam and Adagrad loops do not vectorize: 4.09 ns a
parameter on the card machine's 8 cores against 0.48 without them. The
square root of a second moment (never negative) sets no errno, so the
results are bit-equal to the JAX package's build (the CPU tests hold
them equal). The file
name hashes the sources and the flags, so an edited source rebuilds; this
build is apart from the CUDA kernels' (``ops/kernels/build.py``), so
neither rebuilds the other. A failed build or load raises with the
compiler's output: nothing falls back to a numpy or torch optimizer.

Bindings pass buffers through :func:`buffer_ptr`, which takes a numpy
array or a CPU torch tensor and checks its dtype, contiguity and size
before handing a raw pointer to native code (bf16 crosses as 16-bit words:
a numpy ``uint16`` array or a torch ``bfloat16`` / ``int16`` tensor).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HOST_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = HOST_CSRC.parent / "build"
SOURCES = ("aio.cpp", "cpu_adam.cpp", "cpu_adagrad.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-funroll-loops", "-Wall",
             "-fno-math-errno")
ARCH_FLAGS = ("-march=native",)

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

c_ptr = ctypes.c_void_p
c_i64 = ctypes.c_int64
c_f32 = ctypes.c_float
c_int = ctypes.c_int

# every exported function: (restype, argtypes)
_SIGNATURES = {
    "ds_aio_handle_new": (c_ptr, [c_i64, c_int]),
    "ds_aio_handle_free": (None, [c_ptr]),
    "ds_aio_pread": (None, [c_ptr, c_ptr, ctypes.c_char_p, c_i64]),
    "ds_aio_pwrite": (None, [c_ptr, c_ptr, ctypes.c_char_p, c_i64]),
    "ds_aio_wait": (c_i64, [c_ptr]),
    "ds_aio_inflight": (c_i64, [c_ptr]),
    "ds_aio_last_errno": (c_int, [c_ptr]),
    "ds_adam_step": (None, [c_ptr, c_ptr, c_ptr, c_ptr, c_i64, c_f32, c_f32, c_f32, c_f32,
                            c_f32, c_int, c_f32, c_f32]),
    "ds_adam_step_bf16": (None, [c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_i64, c_f32, c_f32, c_f32,
                                 c_f32, c_f32, c_int, c_f32, c_f32]),
    "ds_adam_step_plus_copy": (None, [c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_i64, c_f32, c_f32,
                                      c_f32, c_f32, c_f32, c_int, c_f32, c_f32]),
    "ds_adagrad_step": (None, [c_ptr, c_ptr, c_ptr, c_i64, c_f32, c_f32, c_f32]),
    "ds_adagrad_step_plus_copy": (None, [c_ptr, c_ptr, c_ptr, c_ptr, c_i64, c_f32, c_f32,
                                         c_f32]),
}


def library_path() -> Path:
    """The library's file: its name hashes every source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + ARCH_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HOST_CSRC / name).read_bytes())
    return BUILD_DIR / f"libdstpu_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built. Returns its path; raises
    RuntimeError with the compiler's output when both attempts fail."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    srcs = [str(HOST_CSRC / s) for s in SOURCES]
    compilers = [c for c in (os.environ.get("CXX"), "g++", "c++", "/usr/bin/g++") if c]
    errors = []
    for cxx in dict.fromkeys(compilers):
        for arch in (ARCH_FLAGS, ()):
            cmd = [cxx, *CXX_FLAGS, *arch, "-shared", *srcs, "-o", str(tmp), "-lpthread"]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                errors.append(f"$ {' '.join(cmd)}\ncannot run {cxx}: {e}")
                break
            if res.returncode == 0:
                os.replace(tmp, out)       # atomic: a concurrent builder never sees half a file
                return out
            errors.append(f"$ {' '.join(cmd)}\n{res.stderr[-2000:]}")
    raise RuntimeError("host library build failed (csrc/host/):\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every function's
    argtypes and restype declared. Thread-safe."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (restype, argtypes) in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.restype, f.argtypes = restype, argtypes
            _LIB = lib
    return _LIB


_TORCH_KIND = {"f32": (torch.float32,), "bits16": (torch.bfloat16, torch.int16),
               "bytes": None}
_NUMPY_KIND = {"f32": (np.dtype(np.float32),), "bits16": (np.dtype(np.uint16),),
               "bytes": None}


def is_bits16(buf) -> bool:
    """Whether ``buf`` carries bf16 as 16-bit words."""
    if isinstance(buf, torch.Tensor):
        return buf.dtype in _TORCH_KIND["bits16"]
    return isinstance(buf, np.ndarray) and buf.dtype in _NUMPY_KIND["bits16"]


def buffer_ptr(buf, kind: str, name: str, numel: Optional[int] = None) -> ctypes.c_void_p:
    """The raw pointer of a host buffer after checking it: a C-contiguous
    numpy array or a contiguous CPU torch tensor; ``kind`` "f32" (float32),
    "bits16" (bf16 words: numpy uint16, torch bfloat16 / int16) or "bytes"
    (any dtype); ``numel`` its expected element count. ctypes would take the
    base pointer of a strided view, so anything else would corrupt memory."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError(f"{name} must be a host tensor, got one on {buf.device}")
        if not buf.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        ok = _TORCH_KIND[kind]
        if ok is not None and buf.dtype not in ok:
            raise TypeError(f"{name} must be {' or '.join(map(str, ok))}, got {buf.dtype}")
        n, ptr = buf.numel(), buf.data_ptr()
    elif isinstance(buf, np.ndarray):
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError(f"{name} must be C-contiguous")
        ok = _NUMPY_KIND[kind]
        if ok is not None and buf.dtype not in ok:
            raise TypeError(f"{name} must be {' or '.join(map(str, ok))}, got {buf.dtype}")
        n, ptr = buf.size, buf.ctypes.data
    else:
        raise TypeError(f"{name} must be a numpy array or a torch tensor, got {type(buf)}")
    if numel is not None and n != numel:
        raise ValueError(f"{name} has {n} elements, expected {numel}")
    return ctypes.c_void_p(ptr)


def nbytes(buf) -> int:
    return buf.numel() * buf.element_size() if isinstance(buf, torch.Tensor) else buf.nbytes
