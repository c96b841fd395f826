"""Per-collective profiling (counterpart of
``deepspeed_tpu/utils/comms_logging.py``).

Every collective of ``deepspeed_tpu_torch.comm`` is timed by its
``_log_wrap`` while the logger is enabled; this module aggregates latency
and algorithmic / bus bandwidth per (op, message size), fans each record
into the telemetry registry (``comm/ops``, ``comm/bytes``,
``comm/latency_ms``, ``comm/busbw_gbps``) and prints the reference-shaped
summary. The message size is the calling rank's own tensor.
"""

from __future__ import annotations

import math
from typing import Dict, List

from deepspeed_tpu_torch.utils.logging import log_dist, logger


def get_caller_func(frame: int = 3) -> str:
    import sys
    return sys._getframe(frame).f_code.co_name


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    size_name = ("B", "KB", "MB", "GB", "TB", "PB", "EB", "ZB", "YB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    s = round(size_bytes / p, 2)
    return f"{s} {size_name[i]}"


def calc_bw_log(comm_op: str, size: int, duration: float, n: int) -> tuple:
    """Algorithmic and bus bandwidth (GB/s) of a collective of ``size``
    bytes a rank over ``n`` ranks taking ``duration`` seconds (the ring
    algorithm's factors)."""
    duration = max(duration, 1e-9)
    if comm_op in ("all_to_all_single", "all_to_all"):
        tput = size / duration
        busbw = (size / duration) * ((n - 1) / n) if n > 0 else 0
    elif comm_op in ("all_gather", "all_gather_into_tensor", "reduce_scatter",
                     "reduce_scatter_tensor"):
        size *= n
        tput = size / duration
        busbw = (size / duration) * ((n - 1) / n) if n > 0 else 0
    elif comm_op in ("all_reduce",):
        tput = size * 2 / duration
        busbw = (size / duration) * (2 * (n - 1) / n) if n > 0 else 0
    elif comm_op in ("send", "recv", "isend", "irecv", "broadcast", "reduce", "gather", "scatter",
                     "barrier", "ppermute"):
        tput = size / duration
        busbw = tput
    else:
        logger.warning(f"Cannot derive bandwidth for unknown comm op {comm_op}")
        return 0, 0
    return tput / 1e9, busbw / 1e9


class CommsLogger:
    """Aggregates per-op / per-size latency and bandwidth records."""

    def __init__(self):
        from deepspeed_tpu_torch.comm.config import CommsLoggerConfig
        defaults = CommsLoggerConfig()
        self.comms_dict: Dict[str, Dict[int, List]] = {}
        self.verbose = defaults.verbose
        self.debug = defaults.debug
        self.prof_ops = defaults.prof_ops
        self.prof_all = defaults.prof_all
        self.enabled = defaults.enabled

    @staticmethod
    def _tel_handles():
        """The registry's families, resolved per call (get-or-create under
        the registry's lock), so a registry reset cannot orphan them."""
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        reg = get_registry()
        return (
            reg.counter("comm/ops", "collective calls", labelnames=("op",)),
            reg.counter("comm/bytes", "collective payload bytes", labelnames=("op",)),
            reg.histogram("comm/latency_ms", "per-collective wall time", labelnames=("op",)),
            reg.histogram("comm/busbw_gbps", "per-collective bus bandwidth",
                          labelnames=("op",)),
        )

    def configure(self, comms_config) -> None:
        self.enabled = comms_config.comms_logger_enabled
        if self.enabled:
            cl = comms_config.comms_logger
            self.verbose = cl.verbose
            self.debug = cl.debug
            self.prof_ops = cl.prof_ops
            self.prof_all = cl.prof_all

    def start_profiling_comms(self):
        self.prof_all = True

    def stop_profiling_comms(self):
        self.prof_all = False

    def start_profiling_op(self, op_name_list):
        self.prof_ops = list(set(self.prof_ops) | set(op_name_list))

    def stop_profiling_op(self, op_name_list):
        self.prof_ops = [op for op in self.prof_ops if op not in op_name_list]

    def append(self, raw_name: str, record_name: str, latency: float, msg_size: int,
               n_ranks: int) -> None:
        """Add a record: ``latency`` in ms, ``msg_size`` in bytes."""
        algbw, busbw = calc_bw_log(raw_name, msg_size, latency / 1e3, n_ranks)
        ops, nbytes, lat, bw = self._tel_handles()
        ops.labels(op=record_name).inc()
        nbytes.labels(op=record_name).inc(msg_size)
        lat.labels(op=record_name).observe(latency)
        bw.labels(op=record_name).observe(busbw * 8)
        sizes = self.comms_dict.setdefault(record_name, {})
        if msg_size in sizes:
            rec = sizes[msg_size]
            rec[0] += 1
            rec[1].append(latency)
            rec[2].append(algbw)
            rec[3].append(busbw)
        else:
            sizes[msg_size] = [1, [latency], [algbw], [busbw]]
        if self.verbose:
            log_dist(f"comm op: {record_name} | time (ms): {latency:.2f} | "
                     f"msg size: {convert_size(msg_size)} | algbw (Gbps): {algbw * 8:.2f} | "
                     f"busbw (Gbps): {busbw * 8:.2f}", ranks=[0])

    def log_all(self, print_log: bool = True, show_straggler: bool = False):
        from deepspeed_tpu_torch.utils.timer import trim_mean
        if print_log:
            print("Comm. Op            Message Size        Count       Total Latency(ms)   "
                  "Avg Latency(ms)     tput_avg (Gbps)     busbw_avg (Gbps)")
        results = {}
        for record_name in self.comms_dict:
            if print_log:
                print(record_name)
            results[record_name] = {}
            for msg_size, vals in sorted(self.comms_dict[record_name].items()):
                count = vals[0]
                total_lat = sum(vals[1])
                avg_lat = trim_mean(vals[1], 0.1)
                avg_algbw = trim_mean(vals[2], 0.1)
                avg_busbw = trim_mean(vals[3], 0.1)
                results[record_name][msg_size] = {
                    "count": count, "total_latency_ms": total_lat, "avg_latency_ms": avg_lat,
                    "algbw_gbps": avg_algbw * 8, "busbw_gbps": avg_busbw * 8,
                }
                if print_log:
                    print(f"{' ':20}{convert_size(msg_size):<20}{count:<12}{total_lat:<20.2f}"
                          f"{avg_lat:<20.2f}{avg_algbw * 8:<20.2f}{avg_busbw * 8:<20.2f}")
        return results
