"""``ds_report`` equivalent (counterpart of ``deepspeed_tpu/env_report.py``;
reference ``env_report.py``): which of the port's kernel libraries are
built, the framework and toolchain versions, the CUDA devices and their
memory.

Run as ``python -m deepspeed_tpu_torch.cli report [--telemetry <jsonl>]``.
Nothing here builds a kernel: the report reads what is on disk.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys

GREEN = "\033[92m"
RED = "\033[91m"
YELLOW = "\033[93m"
END = "\033[0m"
OKAY = f"{GREEN}[OKAY]{END}"
NO = f"{RED}[NO]{END}"


def _dots(name: str, width: int = 23) -> str:
    return name + "." * max(1, width - len(name))


def nvcc_version():
    """``(path, release)`` of the nvcc the kernels build with, or
    ``(None, reason)`` when there is none."""
    from deepspeed_tpu_torch.ops.kernels import build
    try:
        path = build.nvcc_path()
    except RuntimeError as e:
        return None, str(e).split(" (")[0]
    res = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    m = re.search(r"release ([\d.]+)", res.stdout)
    return path, m.group(1) if m else "unknown"


def op_report(verbose: bool = True):
    """One row per kernel library of ``ops/kernels/build.py`` (CUDA, nvcc at
    first use) and the host library of ``ops/native.py`` (g++ at first use):
    whether this checkout has it built. Returns ``[(name, built)]``."""
    from deepspeed_tpu_torch.ops import native
    from deepspeed_tpu_torch.ops.kernels import build

    print("-" * 64)
    print("deepspeed_tpu_torch kernel library report")
    print("-" * 64)
    print(_dots("library") + " built  source")
    print("-" * 64)
    rows = []
    for name, source in sorted(build.SOURCES.items()):
        built = build.library_path(name).exists()
        print(_dots(name) + f" {OKAY if built else NO} csrc/{source}")
        rows.append((name, built))
    built = native.library_path().exists()
    print(_dots("host (aio, cpu_adam)") + f" {OKAY if built else NO} csrc/host/*.cpp")
    rows.append(("host", built))
    if verbose:
        print("libraries build on first use into deepspeed_tpu_torch/csrc/build/")
    return rows


def version_report():
    print("-" * 64)
    print("framework / toolchain versions")
    print("-" * 64)
    import deepspeed_tpu_torch
    import torch
    print(f"{_dots('deepspeed_tpu_torch', 21)} {deepspeed_tpu_torch.__version__}")
    print(f"{_dots('python', 21)} {sys.version.split()[0]}")
    print(f"{_dots('torch', 21)} {torch.__version__}")
    print(f"{_dots('torch CUDA', 21)} {torch.version.cuda or 'none (a CPU build)'}")
    path, release = nvcc_version()
    print(f"{_dots('nvcc', 21)} " + (f"{release} ({path})" if path else
                                     f"{YELLOW}{release}{END}"))
    for mod in ("numpy", "triton"):
        try:
            m = importlib.import_module(mod)
            print(f"{_dots(mod, 21)} {getattr(m, '__version__', '?')}")
        except ImportError:
            print(f"{_dots(mod, 21)} {YELLOW}not installed{END}")


def device_report():
    """The CUDA devices: name, compute capability and memory. Returns
    ``[(name, (major, minor), total_bytes)]``."""
    import torch
    print("-" * 64)
    print("devices")
    print("-" * 64)
    if not torch.cuda.is_available():
        print(f"{YELLOW}no CUDA device (torch.cuda.is_available() is false){END}")
        return []
    rows = []
    print(f"{_dots('device count', 21)} {torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        rows.append((p.name, (p.major, p.minor), p.total_memory))
        print(f"  cuda:{i}  {p.name}  sm_{p.major}{p.minor}  "
              f"{p.total_memory / 2.0 ** 30:.2f} GiB  {p.multi_processor_count} SMs")
    return rows


def memory_report():
    print("-" * 64)
    print("device memory")
    print("-" * 64)
    # host RSS first: it stays printable even when the device is what is broken
    from deepspeed_tpu_torch.monitor.health import host_rss_bytes
    rss = host_rss_bytes()
    if rss:
        print(f"  host RSS: {rss / 2.0 ** 30:.2f}GB")
    import torch
    if not torch.cuda.is_available():
        print(f"  {YELLOW}no CUDA device{END}")
        return
    from deepspeed_tpu_torch.accelerator import get_accelerator
    gb = 2.0 ** 30
    for name, st in get_accelerator("cuda").memory_report().items():
        print(f"  {name}: in_use {st['bytes_in_use'] / gb:.2f}GB  "
              f"peak {st['peak_bytes_in_use'] / gb:.2f}GB  "
              f"limit {st['bytes_limit'] / gb:.2f}GB  "
              f"headroom {st['headroom_bytes'] / gb:.2f}GB")


def telemetry_report(path: str):
    """Latest snapshot summary from a JSONL telemetry sink (the same
    renderer the ``health`` screen uses)."""
    print("-" * 64)
    print(f"latest telemetry snapshot ({path})")
    print("-" * 64)
    from deepspeed_tpu_torch.monitor.health import read_last_snapshots, render_health_table
    recs = read_last_snapshots(path, 2)
    if not recs:
        print(f"{YELLOW}no parseable records{END}")
        return
    print(render_health_table(recs[-1], recs[-2] if len(recs) > 1 else None))


def main(hide_operator_status: bool = False, hide_errors_and_warnings: bool = False,
         telemetry_path=None):
    if not hide_operator_status:
        op_report(verbose=not hide_errors_and_warnings)
    version_report()
    device_report()
    memory_report()
    if telemetry_path:
        telemetry_report(telemetry_path)


def cli_main():
    main()


if __name__ == "__main__":
    main()
