"""Memory telemetry (the part of ``deepspeed_tpu/monitor/health.py`` the
port has): the ``mem/*`` gauges from the accelerator's memory report plus
host RSS. The health observatory itself (sentinels, anomaly detectors,
debug bundles) is not ported (ROADMAP.md queue 1, telemetry and control
plane)."""

from __future__ import annotations

import os
import sys
from typing import Any, Dict


def host_rss_bytes() -> int:
    """Resident set size of this process (0 when unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        pass
    try:
        import resource
        # ru_maxrss is the PEAK rss — a usable fallback; linux reports
        # kilobytes, macOS reports bytes
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024
    except Exception:
        return 0


def sample_memory_gauges(registry=None, accelerator=None) -> Dict[str, Any]:
    """Refresh the ``mem/*`` gauges from ``accelerator.memory_report()``
    (device live/peak/limit/headroom bytes per device) plus host RSS;
    returns the sampled report. A device without memory stats (the CPU)
    contributes an empty entry and no gauges. ``accelerator`` defaults to
    the CUDA one when a device is there, else the CPU's."""
    if registry is None:
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        registry = get_registry()
    report: Dict[str, Any] = {"devices": {}, "host_rss_bytes": host_rss_bytes()}
    try:
        if accelerator is None:
            from deepspeed_tpu_torch.accelerator.real_accelerator import default_accelerator
            accelerator = default_accelerator()
        devmap = accelerator.memory_report()
    except Exception:
        devmap = {}
    report["devices"] = devmap
    in_use = registry.gauge("mem/hbm_bytes_in_use",
                            "live HBM bytes per device", labelnames=("device",))
    peak = registry.gauge("mem/hbm_peak_bytes",
                          "peak HBM bytes per device", labelnames=("device",))
    limit = registry.gauge("mem/hbm_bytes_limit",
                           "allocator byte limit per device",
                           labelnames=("device",))
    headroom = registry.gauge("mem/hbm_headroom_bytes",
                              "limit - live bytes per device",
                              labelnames=("device",))
    for name, st in devmap.items():
        if not st:
            continue
        in_use.labels(device=name).set(st.get("bytes_in_use", 0))
        peak.labels(device=name).set(st.get("peak_bytes_in_use", 0))
        limit.labels(device=name).set(st.get("bytes_limit", 0))
        headroom.labels(device=name).set(st.get("headroom_bytes", 0))
    registry.gauge("mem/host_rss_bytes",
                   "host resident set size").set(report["host_rss_bytes"])
    return report
