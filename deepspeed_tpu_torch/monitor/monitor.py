"""Monitoring fan-out (counterpart of ``deepspeed_tpu/monitor/monitor.py``;
reference: deepspeed/monitor/monitor.py).

``MonitorMaster`` forwards scalar events to every enabled sink
(TensorBoard through ``torch.utils.tensorboard``, W&B, CSV) with the JAX
package's file layout. Only rank 0 writes. A sink whose package is missing
warns and turns itself off, as the JAX one does.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from deepspeed_tpu_torch.monitor.config import DeepSpeedMonitorConfig
from deepspeed_tpu_torch.utils.logging import logger


class Monitor:

    def __init__(self, monitor_config):
        self.monitor_config = monitor_config

    def write_events(self, event_list: List[Tuple[str, float, int]]) -> None:
        raise NotImplementedError


class TensorBoardMonitor(Monitor):

    def __init__(self, tensorboard_config):
        super().__init__(tensorboard_config)
        self.enabled = tensorboard_config.enabled
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
                log_dir = os.path.join(tensorboard_config.output_path or "./runs",
                                       tensorboard_config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                logger.warning("tensorboard not available; TensorBoardMonitor disabled")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        if self.summary_writer is None:
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, value, step)
        if flush:
            self.summary_writer.flush()


class WandbMonitor(Monitor):

    def __init__(self, wandb_config):
        super().__init__(wandb_config)
        self.enabled = wandb_config.enabled
        if self.enabled:
            try:
                import wandb
                self.wandb = wandb
                wandb.init(project=wandb_config.project, group=wandb_config.group, entity=wandb_config.team)
            except ImportError:
                logger.warning("wandb not available; WandbMonitor disabled")
                self.enabled = False

    def write_events(self, event_list):
        if not self.enabled:
            return
        for name, value, step in event_list:
            self.wandb.log({name: value}, step=step)


class csvMonitor(Monitor):

    def __init__(self, csv_config):
        super().__init__(csv_config)
        self.enabled = csv_config.enabled
        self.output_path = csv_config.output_path or "./csv_monitor"
        self.job_name = csv_config.job_name
        self.filenames: dict = {}
        if self.enabled:
            os.makedirs(os.path.join(self.output_path, self.job_name), exist_ok=True)

    def write_events(self, event_list):
        if not self.enabled:
            return
        # group by metric name: each per-metric file is opened/closed ONCE
        # per call, not once per event (a telemetry snapshot fans out
        # hundreds of events; per-event open() made this O(events) syscalls)
        by_name: dict = {}
        for name, value, step in event_list:
            by_name.setdefault(name, []).append((step, value))
        for name, rows in by_name.items():
            safe = name.replace("/", "_")
            path = os.path.join(self.output_path, self.job_name, f"{safe}.csv")
            new = not os.path.exists(path)
            with open(path, "a") as f:
                if new:
                    f.write("step,value\n")
                f.writelines(f"{step},{value}\n" for step, value in rows)


class MonitorMaster(Monitor):

    def __init__(self, monitor_config: DeepSpeedMonitorConfig):
        super().__init__(monitor_config)
        rank = int(os.environ.get("RANK", 0))
        try:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                rank = dist.get_rank()
        except Exception:
            pass
        self.rank = rank
        self.tb_monitor = None
        self.wandb_monitor = None
        self.csv_monitor = None
        if rank == 0:
            if monitor_config.tensorboard.enabled:
                self.tb_monitor = TensorBoardMonitor(monitor_config.tensorboard)
            if monitor_config.wandb.enabled:
                self.wandb_monitor = WandbMonitor(monitor_config.wandb)
            if monitor_config.csv_monitor.enabled:
                self.csv_monitor = csvMonitor(monitor_config.csv_monitor)
        self.enabled = any(m is not None and m.enabled
                           for m in (self.tb_monitor, self.wandb_monitor, self.csv_monitor))

    def write_events(self, event_list):
        if self.rank != 0:
            return
        for m in (self.tb_monitor, self.wandb_monitor, self.csv_monitor):
            if m is not None and m.enabled:
                m.write_events(event_list)
