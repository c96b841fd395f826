"""Rank-aware logging utilities (the port's copy of
``deepspeed_tpu/utils/logging.py``): logger factory, ``log_dist``
rank-filtered logging, ``warn_once``. Rank discovery reads the launcher's
environment, then ``torch.distributed`` when it is initialised."""

from __future__ import annotations

import functools
import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:

    @staticmethod
    def create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    name="deepspeed_tpu_torch",
    level=log_levels.get(os.environ.get("DS_TPU_LOG_LEVEL", "info"), logging.INFO))


def _get_rank() -> int:
    """Rank of this process, without forcing distributed init."""
    for var in ("RANK", "PROCESS_ID"):
        if var in os.environ:
            try:
                return int(os.environ[var])
            except ValueError:
                pass
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (``[-1]`` or None = all)."""
    my_rank = _get_rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


@functools.lru_cache(None)
def warn_once(message: str) -> None:
    logger.warning(message)
