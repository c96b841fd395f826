"""Per-node process launcher (counterpart of
``deepspeed_tpu/launcher/launch.py``).

Spawns one rank per local GPU slot with the distributed environment
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
which ``torch.distributed``'s ``env://`` reads as they are, the JAX
package's ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``, and
``CUDA_VISIBLE_DEVICES`` set to the rank's slot where JAX sets
``TPU_VISIBLE_CHIPS``), writes a pidfile, forwards SIGINT / SIGTERM to the
ranks, and stops every rank if one fails.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List

from deepspeed_tpu_torch.launcher.runner import decode_world_info
from deepspeed_tpu_torch.utils.logging import logger


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="per-node deepspeed_tpu_torch launcher")
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--world_info", type=str, required=True, help="base64 world info")
    parser.add_argument("--save_pid", action="store_true")
    parser.add_argument("--enable_each_rank_log", default=None, type=str,
                        help="redirect each rank's stdout/err into this directory")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def build_rank_env(world_info: Dict[str, List[int]], node_rank: int, local_rank_idx: int,
                   master_addr: str, master_port: int) -> Dict[str, str]:
    """The distributed env block for one worker (pure; unit-testable)."""
    hosts = list(world_info.keys())
    node_host = hosts[node_rank]
    local_slots = world_info[node_host]
    global_rank = sum(len(world_info[h]) for h in hosts[:node_rank]) + local_rank_idx
    world_size = sum(len(slots) for slots in world_info.values())
    return {
        "RANK": str(global_rank),
        "LOCAL_RANK": str(local_rank_idx),
        "LOCAL_SIZE": str(len(local_slots)),
        "WORLD_SIZE": str(world_size),
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
        "COORDINATOR_ADDRESS": f"{master_addr}:{master_port}",
        "NUM_PROCESSES": str(world_size),
        "PROCESS_ID": str(global_rank),
        "CUDA_VISIBLE_DEVICES": str(local_slots[local_rank_idx]),
    }


def main(args=None):
    args = parse_args(args)
    world_info = decode_world_info(args.world_info)
    hosts = list(world_info.keys())
    node_host = hosts[args.node_rank]
    local_slots = world_info[node_host]

    processes: List[subprocess.Popen] = []

    # install forwarding handlers BEFORE spawning so an interrupt mid-spawn
    # cannot orphan already-started ranks (reference launch.py:292)
    def sig_handler(signum, frame):
        for p in processes:
            try:
                p.send_signal(signum)
            except ProcessLookupError:
                pass
        sys.exit(128 + signum)

    signal.signal(signal.SIGINT, sig_handler)
    signal.signal(signal.SIGTERM, sig_handler)

    log_dir = args.enable_each_rank_log
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    for local_rank in range(len(local_slots)):
        env = os.environ.copy()
        env.update(build_rank_env(world_info, args.node_rank, local_rank,
                                  args.master_addr, args.master_port))
        cmd = [sys.executable, "-u", args.user_script] + args.user_args
        if log_dir:
            rank = env["RANK"]
            with open(os.path.join(log_dir, f"rank_{rank}.log"), "w") as out:
                p = subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT)
        else:
            p = subprocess.Popen(cmd, env=env)
        processes.append(p)

    if args.save_pid:
        pidfile = os.path.join(tempfile.gettempdir(), f"ds_launch_{os.getpid()}.pids")
        with open(pidfile, "w") as fd:
            json.dump([p.pid for p in processes], fd)
        logger.info(f"pids saved to {pidfile}")

    # monitor: any failure kills the tree (reference launch.py:103-117)
    alive = {p.pid: p for p in processes}
    exit_code = 0
    while alive:
        time.sleep(0.2)
        for pid, p in list(alive.items()):
            ret = p.poll()
            if ret is None:
                continue
            del alive[pid]
            if ret != 0:
                logger.error(f"rank process {pid} exited with code {ret}; terminating job")
                exit_code = ret
                _stop(list(alive.values()))
                alive = {}
                break
    sys.exit(exit_code)


def _stop(procs: List[subprocess.Popen], grace_s: float = 5.0) -> None:
    """SIGTERM every rank still running, then SIGKILL those alive after
    ``grace_s``; every rank is reaped before the launcher exits."""
    for q in procs:
        try:
            q.terminate()
        except ProcessLookupError:
            pass
    deadline = time.time() + grace_s
    for q in procs:
        try:
            q.wait(timeout=max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


if __name__ == "__main__":
    main()
