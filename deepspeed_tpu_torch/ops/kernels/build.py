"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``.cu`` source under ``deepspeed_tpu_torch/csrc/`` has a plain C
interface (pointers, ints, a stream) and compiles, on first use, into its
own shared library under ``csrc/build/``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o csrc/build/lib<name>_<hash>.so csrc/<source>.cu

No PyTorch headers are involved, so a build takes seconds. The library name
carries a hash of the sources and flags, so an edited kernel is rebuilt and
a stale one is never loaded. :func:`build` starts one nvcc per missing
library, all at once, and waits for them; :func:`load` builds what it needs
and returns the ``ctypes.CDLL``. Nothing here runs at import time: the CPU
tests import every module of the package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from deepspeed_tpu_torch.monitor.trace import get_compile_watchdog

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# library name -> its source; every source may include any header in csrc/
SOURCES: Dict[str, str] = {
    "flash_attention": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
    "dense_decode_attention": "dense_decode_attention.cu",
    "fused_adam": "fused_adam.cu",
    "fused_cross_entropy": "fused_cross_entropy.cu",
    "fused_lamb": "fused_lamb.cu",
    "sr_quantize": "sr_quantize.cu",
    "dequant_int8": "dequant_int8.cu",
    "spatial_bias_add": "spatial_bias_add.cu",
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source on "
                       "first use")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: the file name hashes the source, every
    header in ``csrc/`` (``*.cuh``, so a new header can never leave a stale
    library loaded) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, ptxas_verbose: bool = False):
    """Compile every library in ``names`` (default: all) that is not built
    yet, one nvcc process per source, all started together. Returns
    ``(seconds, log)`` where ``log`` maps each compiled name to nvcc's
    output (register and shared-memory use with ``ptxas_verbose``).
    Raises RuntimeError, with nvcc's output, when a compile fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    t0 = time.perf_counter()
    log: Dict[str, str] = {}
    if not todo:
        return 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        log[n] = text
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]} (rc {p.returncode}):\n{text}")
            continue
        os.replace(tmp, out)       # atomic: a concurrent builder never sees half a file
        # the telemetry's counterpart of a compile: name and wall seconds
        get_compile_watchdog().record_build(n, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
