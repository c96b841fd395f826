"""Spawning gloo ranks for the port's multi-process CPU tests: through the
port's own ``launcher/launch.py`` (or ``cli run``), one thread a rank, a
free ``MASTER_PORT`` from a socket bound to port 0, a timeout on every
spawn, each rank's output in its own log (quoted when a launch fails)."""

import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT), **extra)
    return env


def run_launch(cmd, log_dir, timeout, env=None):
    """Run a launcher command line; on a non-zero exit raise with every
    rank log's tail."""
    proc = subprocess.run(cmd, cwd=ROOT, env=env or rank_env(), capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        logs = []
        for p in sorted(pathlib.Path(log_dir).glob("rank_*.log")):
            logs.append(f"--- {p.name}\n{p.read_text()[-3000:]}")
        raise RuntimeError(f"launch exited {proc.returncode}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-3000:]}\n" + "\n".join(logs))
    return proc


def launch(script, n, args, log_dir, timeout=120, env=None):
    """``n`` local ranks of ``script`` through ``launcher/launch.py``."""
    from deepspeed_tpu_torch.launcher.runner import encode_world_info
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
           f"--world_info={encode_world_info({'localhost': list(range(n))})}",
           "--master_addr=127.0.0.1", f"--master_port={free_port()}",
           f"--enable_each_rank_log={log_dir}", str(script), *args]
    return run_launch(cmd, log_dir, timeout, env)
