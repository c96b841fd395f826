"""``dscli run``: the launcher's front-end (counterpart of
``deepspeed_tpu/launcher/runner.py``).

Parses the hostfile and the include / exclude filters, encodes the world
layout, and either spawns the per-node
:mod:`deepspeed_tpu_torch.launcher.launch` locally or builds the multi-node
command (PDSH, OpenMPI, MPICH, MVAPICH, Intel MPI, SLURM). Hostfile syntax,
filter grammar (``host1@host2:0,2``), the base64 world info and
``.deepspeed_env`` follow the JAX package and the reference; the spawned
ranks meet in ``torch.distributed`` (``comm.init_distributed``, the first
host's address). Where the JAX package exports its TPU variables to remote
nodes, the port exports the CUDA ones (:data:`EXPORT_ENVS`).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import re
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

from deepspeed_tpu_torch.launcher.multinode_runner import (IMPIRunner, MPICHRunner, MVAPICHRunner,
                                                           OpenMPIRunner, PDSHRunner,
                                                           SlurmRunner)
from deepspeed_tpu_torch.utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"
# the JAX list with its TPU prefixes swapped for their CUDA counterparts:
# JAX_ -> TORCH_, LIBTPU -> NCCL_, TPU_ -> CUDA_, XLA_ -> PYTORCH_
EXPORT_ENVS = ["MLFLOW", "DS_", "TORCH_", "NCCL_", "CUDA_", "PYTHON", "PYTORCH_"]
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
DEEPSPEED_ENVIRONMENT_PATHS = [".", os.path.expanduser("~")]


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="dscli launcher: run a deepspeed_tpu_torch training script over one "
                    "or many hosts, one rank per GPU")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="Hostfile path: lines of '<host> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="Resource filter, e.g. 'host1@host2:0,2'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="Resource exclusion filter, same grammar as --include")
    parser.add_argument("--num_nodes", type=int, default=-1)
    parser.add_argument("--num_gpus", "--num_chips", dest="num_gpus", type=int, default=-1,
                        help="Processes (GPUs) per node")
    parser.add_argument("--master_port", type=int,
                        default=int(os.environ.get("DLTS_MASTER_PORT", 29500)))
    parser.add_argument("--master_addr", type=str, default="")
    parser.add_argument("--launcher", type=str, default="pdsh",
                        choices=["pdsh", "openmpi", "mpich", "slurm", "mvapich", "impi"])
    parser.add_argument("--launcher_args", type=str, default="")
    parser.add_argument("--force_multi", action="store_true")
    parser.add_argument("--save_pid", action="store_true")
    parser.add_argument("--enable_each_rank_log", default=None, type=str)
    parser.add_argument("user_script", type=str, help="User script to launch")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


# ------------------------------------------------------------------ #
# hostfile handling (reference runner.py:176-230)

def fetch_hostfile(hostfile_path: str) -> Optional[Dict[str, int]]:
    if not os.path.isfile(hostfile_path):
        return None
    resource_pool: "OrderedDict[str, int]" = OrderedDict()
    with open(hostfile_path, "r") as fd:
        for line in fd:
            line = line.strip()
            if line == "" or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                key, slot_count = slots.split("=")
                if key != "slots":
                    raise ValueError(f"expected 'slots=<n>', got {slots!r}")
                slot_count = int(slot_count)
            except ValueError:
                logger.error(f"Hostfile is not formatted correctly: {line}")
                raise ValueError(f"Hostfile is not formatted correctly: {line}")
            if hostname in resource_pool:
                raise ValueError(f"Hostfile contains duplicate hosts: {hostname}")
            resource_pool[hostname] = slot_count
    return resource_pool


def _parse_hostfile_filter(filter_str: str) -> Dict[str, Optional[List[int]]]:
    """'host1@host2:0,2' → {host1: None, host2: [0, 2]}; None = all slots."""
    mapping: "OrderedDict[str, Optional[List[int]]]" = OrderedDict()
    if not filter_str:
        return mapping
    for part in filter_str.split("@"):
        if ":" in part:
            host, slots = part.split(":")
            mapping[host] = [int(s) for s in slots.split(",")]
        else:
            mapping[part] = None
    return mapping


def parse_resource_filter(host_info: Dict[str, int], include_str: str = "",
                          exclude_str: str = "") -> Dict[str, List[int]]:
    """Apply include/exclude filters (reference runner.py:231-300)."""
    if include_str and exclude_str:
        raise ValueError("--include and --exclude are mutually exclusive")

    pool: "OrderedDict[str, List[int]]" = OrderedDict(
        (host, list(range(slots))) for host, slots in host_info.items())

    if include_str:
        include = _parse_hostfile_filter(include_str)
        filtered: "OrderedDict[str, List[int]]" = OrderedDict()
        for host, slots in include.items():
            if host not in pool:
                raise ValueError(f"Include host {host} not in hostfile")
            use = slots if slots is not None else pool[host]
            bad = [s for s in use if s not in pool[host]]
            if bad:
                raise ValueError(f"Include slots {bad} not available on {host}")
            filtered[host] = sorted(use)
        return filtered

    if exclude_str:
        exclude = _parse_hostfile_filter(exclude_str)
        for host, slots in exclude.items():
            if host not in pool:
                raise ValueError(f"Exclude host {host} not in hostfile")
            if slots is None:
                del pool[host]
            else:
                pool[host] = [s for s in pool[host] if s not in slots]
                if not pool[host]:
                    del pool[host]
    return pool


def encode_world_info(world_info: Dict[str, List[int]]) -> str:
    json_str = json.dumps(world_info)
    return base64.urlsafe_b64encode(json_str.encode()).decode()


def decode_world_info(encoded: str) -> Dict[str, List[int]]:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


# ------------------------------------------------------------------ #

def _local_chip_count() -> int:
    """The local rank count: ``DS_NUM_CHIPS``, else the CUDA devices
    (``torch.cuda.device_count``, which creates no CUDA context), at
    least 1."""
    if "DS_NUM_CHIPS" in os.environ:
        return int(os.environ["DS_NUM_CHIPS"])
    import torch
    return max(1, torch.cuda.device_count())


def main(args=None):
    args = parse_args(args)

    resource_pool = fetch_hostfile(args.hostfile)

    if resource_pool is None:
        n = args.num_gpus if args.num_gpus > 0 else _local_chip_count()
        resource_pool = {"localhost": n}

    active_resources = parse_resource_filter(resource_pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active_resources = OrderedDict(list(active_resources.items())[:args.num_nodes])
    if args.num_gpus > 0:
        active_resources = OrderedDict(
            (host, list(range(args.num_gpus))) for host in active_resources)

    # multi-node-ness is a property of the POST-filter layout (reference
    # computes it from active_resources): --include narrowing to one host
    # must take the local path
    multi_node = len(active_resources) > 1

    if args.launcher != "pdsh" and multi_node and (
            args.include or args.exclude or args.num_nodes > 0 or args.num_gpus > 0):
        raise ValueError(f"launcher {args.launcher} does not support worker "
                         "include/exclusion or node/chip count overrides "
                         "(mpirun/srun schedule from the full hostfile)")

    if not args.master_addr:
        args.master_addr = next(iter(active_resources))
        if args.master_addr == "localhost":
            args.master_addr = "127.0.0.1"

    world_info = encode_world_info(
        {h: (s if isinstance(s, list) else list(range(s))) for h, s in active_resources.items()})

    if not multi_node and not args.force_multi:
        # single node: exec launch.py directly
        cmd = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
               f"--world_info={world_info}", "--node_rank=0",
               f"--master_addr={args.master_addr}", f"--master_port={args.master_port}"]
        if args.save_pid:
            cmd.append("--save_pid")
        if args.enable_each_rank_log:
            cmd.append(f"--enable_each_rank_log={args.enable_each_rank_log}")
        cmd += [args.user_script] + args.user_args
        logger.info(f"cmd = {' '.join(cmd)}")
        result = subprocess.Popen(cmd, env=os.environ.copy())
        result.wait()
        if result.returncode != 0:
            sys.exit(result.returncode)
        return

    runner_cls = {"pdsh": PDSHRunner, "openmpi": OpenMPIRunner,
                  "mpich": MPICHRunner, "slurm": SlurmRunner,
                  "mvapich": MVAPICHRunner, "impi": IMPIRunner}[args.launcher]
    runner = runner_cls(args, world_info)
    if not runner.backend_exists():
        raise RuntimeError(f"launcher backend {args.launcher} not installed on this host")

    # propagate whitelisted env vars + .deepspeed_env entries (runner.py:30-35)
    env = os.environ.copy()
    for var, val in env.items():
        if any(var.startswith(prefix) for prefix in EXPORT_ENVS):
            runner.add_export(var, val)
    for path in DEEPSPEED_ENVIRONMENT_PATHS:
        env_file = os.path.join(path, DEEPSPEED_ENVIRONMENT_NAME)
        if os.path.isfile(env_file):
            with open(env_file) as fd:
                for line in fd:
                    line = line.strip()
                    if line and not line.startswith("#") and "=" in line:
                        key, val = line.split("=", 1)
                        runner.add_export(key, val)

    cmd = runner.get_cmd(env, active_resources)
    logger.info(f"cmd = {' '.join(cmd)}")
    result = subprocess.Popen(cmd, env=env)
    result.wait()
    if result.returncode != 0:
        sys.exit(result.returncode)


if __name__ == "__main__":
    main()
