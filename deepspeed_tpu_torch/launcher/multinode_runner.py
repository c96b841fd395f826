"""Multi-node launch command builders (counterpart of
``deepspeed_tpu/launcher/multinode_runner.py``).

Each runner turns (user script, world layout, env exports) into the shell
command that starts the ranks on every node: PDSH one
:mod:`deepspeed_tpu_torch.launcher.launch` a node, the MPI launchers and
SLURM one process a rank, which ``comm.init_distributed`` places from the
launcher's own variables. The builders only construct commands (no ssh), as
the JAX package's do; their command lines are the JAX ones with the port's
launch module.
"""

from __future__ import annotations

import os
import shlex
import sys
import tempfile
from abc import ABC, abstractmethod
from typing import Dict, List

PDSH_MAX_FAN_OUT = 1024


class MultiNodeRunner(ABC):
    def __init__(self, args, world_info_base64: str):
        self.args = args
        self.user_arguments = list(getattr(args, "user_args", []) or [])
        self.user_script = getattr(args, "user_script", "")
        self.world_info_base64 = world_info_base64
        self.exports: Dict[str, str] = {}

    @abstractmethod
    def get_cmd(self, environment: Dict[str, str], active_resources: Dict[str, List[int]]) -> List[str]:
        """The full launch command for this backend."""

    @abstractmethod
    def backend_exists(self) -> bool:
        """Whether the backend binary is available on this host."""

    def add_export(self, key: str, var: str) -> None:
        self.exports[key.strip()] = var.strip()

    @property
    def name(self) -> str:
        return type(self).__name__.lower().replace("runner", "")


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out: one launch.py per host over ssh (reference ``:48``)."""

    def backend_exists(self) -> bool:
        return _which("pdsh")

    def get_cmd(self, environment, active_resources):
        environment["PDSH_RCMD_TYPE"] = "ssh"
        active_workers = ",".join(active_resources.keys())

        exports = ""
        for key, val in self.exports.items():
            exports += f"export {key}={shlex.quote(val)}; "

        deepspeed_launch = [
            exports + f"cd {os.path.abspath('.')};",
            sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
            f"--world_info={self.world_info_base64}",
            "--node_rank=%n",
            f"--master_addr={self.args.master_addr}",
            f"--master_port={self.args.master_port}",
        ]
        if getattr(self.args, "save_pid", False):
            deepspeed_launch.append("--save_pid")
        if getattr(self.args, "enable_each_rank_log", None):
            deepspeed_launch.append(f"--enable_each_rank_log={self.args.enable_each_rank_log}")
        return (["pdsh", "-S", "-f", str(PDSH_MAX_FAN_OUT), "-w", active_workers] + deepspeed_launch
                + [self.user_script] + self.user_arguments)


class OpenMPIRunner(MultiNodeRunner):
    """mpirun -np <world> with one rank per GPU."""

    def backend_exists(self) -> bool:
        return _which("mpirun")

    def get_cmd(self, environment, active_resources):
        total_process_count = sum(len(v) for v in active_resources.values())
        mpirun_cmd = [
            "mpirun", "-n", f"{total_process_count}",
            "-hostfile", self.args.hostfile,
            "--mca", "btl", "^openib",
        ] + shlex.split(getattr(self.args, "launcher_args", "") or "")
        export_cmd = []
        # workers discover rank/size from OMPI_* env (comm.init_distributed);
        # the coordinator address must ride along explicitly
        self.add_export("MASTER_ADDR", str(self.args.master_addr))
        self.add_export("MASTER_PORT", str(self.args.master_port))
        for k, v in self.exports.items():
            export_cmd += ["-x", f"{k}={v}"]
        python_exec = [sys.executable, "-u"]
        return mpirun_cmd + export_cmd + python_exec + [self.user_script] + self.user_arguments


class MPICHRunner(MultiNodeRunner):
    def backend_exists(self) -> bool:
        return _which("mpirun")

    def get_cmd(self, environment, active_resources):
        total_process_count = sum(len(v) for v in active_resources.values())
        mpirun_cmd = ["mpirun", "-n", f"{total_process_count}", "-ppn",
                      f"{len(next(iter(active_resources.values())))}"] + \
            shlex.split(getattr(self.args, "launcher_args", "") or "")
        export_cmd = []
        self.add_export("MASTER_ADDR", str(self.args.master_addr))
        self.add_export("MASTER_PORT", str(self.args.master_port))
        for k, v in self.exports.items():
            export_cmd += ["-genv", k, str(v)]
        return mpirun_cmd + export_cmd + [sys.executable, "-u", self.user_script] + self.user_arguments


class MVAPICHRunner(MultiNodeRunner):
    """MVAPICH2 mpirun: one rank per GPU, a hostfile written from the world
    layout (under the temp dir), the JAX runner's MV2 exports."""

    HOSTFILE = None     # default: deepspeed_tpu_torch_mvapich_hostfile in the temp dir

    def __init__(self, args, world_info_base64: str):
        super().__init__(args, world_info_base64)
        self.add_export("MV2_SMP_USE_CMA", "0")        # CMA absent on Ubuntu
        self.add_export("MV2_DEBUG_SHOW_BACKTRACE", "1")
        self.add_export("MV2_SUPPORT_DL", "1")
        self.add_export("MV2_ENABLE_AFFINITY", "0")    # MPI_THREAD_MULTIPLE

    def backend_exists(self) -> bool:
        # mpiname ships with mvapich; plain `mpirun` alone could be openmpi
        return _which("mpiname")

    def get_cmd(self, environment, active_resources):
        per_node = [len(v) for v in active_resources.values()]
        if len(set(per_node)) > 1:
            raise ValueError("mvapich requires the same number of chips per node")
        total_process_count = sum(per_node)
        hostfile = self.HOSTFILE or os.path.join(tempfile.gettempdir(),
                                                 "deepspeed_tpu_torch_mvapich_hostfile")
        with open(hostfile, "w") as fd:
            for host in active_resources:
                fd.write(f"{host}\n")
        mpirun_cmd = [
            "mpirun", "-np", f"{total_process_count}",
            "-ppn", f"{per_node[0]}",
            "--hostfile", hostfile,
        ] + shlex.split(getattr(self.args, "launcher_args", "") or "")
        self.add_export("MASTER_ADDR", str(self.args.master_addr))
        self.add_export("MASTER_PORT", str(self.args.master_port))
        export_cmd = []
        for k, v in self.exports.items():
            export_cmd += ["-env", f"{k}={v}"]
        return mpirun_cmd + export_cmd + [sys.executable, "-u", self.user_script] \
            + self.user_arguments


class IMPIRunner(MultiNodeRunner):
    """Intel MPI mpirun (reference ``:184``): rank/size via PMI env, per-host
    -hosts list, -genv exports."""

    def backend_exists(self) -> bool:
        return _which("mpirun")

    def get_cmd(self, environment, active_resources):
        per_node = [len(v) for v in active_resources.values()]
        if len(set(per_node)) > 1:
            raise ValueError("impi requires the same number of chips per node")
        total_process_count = sum(per_node)
        mpirun_cmd = [
            "mpirun", "-ppn", f"{per_node[0]}",
            "-n", f"{total_process_count}",
            "-hosts", ",".join(active_resources.keys()),
        ] + shlex.split(getattr(self.args, "launcher_args", "") or "")
        self.add_export("MASTER_ADDR", str(self.args.master_addr))
        self.add_export("MASTER_PORT", str(self.args.master_port))
        export_cmd = []
        for k, v in self.exports.items():
            export_cmd += ["-genv", k, str(v)]
        return mpirun_cmd + export_cmd + [sys.executable, "-u", self.user_script] \
            + self.user_arguments


class SlurmRunner(MultiNodeRunner):
    def backend_exists(self) -> bool:
        return _which("sinfo")

    def get_cmd(self, environment, active_resources):
        total_process_count = sum(len(v) for v in active_resources.values())
        srun_cmd = ["srun", "-n", f"{total_process_count}"] + \
            shlex.split(getattr(self.args, "launcher_args", "") or "")
        self.add_export("MASTER_ADDR", str(self.args.master_addr))
        self.add_export("MASTER_PORT", str(self.args.master_port))
        if getattr(self.args, "include", ""):
            srun_cmd += ["--include", f"{self.args.include}"]
        if getattr(self.args, "exclude", ""):
            srun_cmd += ["--exclude", f"{self.args.exclude}"]
        if getattr(self.args, "num_nodes", -1) > 0:
            srun_cmd += ["--nodes", f"{self.args.num_nodes}"]
        exports = ""
        for key, val in self.exports.items():
            exports += f",{key}={val}"
        if exports:
            srun_cmd += ["--export", f"ALL{exports}"]
        return srun_cmd + [sys.executable, "-u", self.user_script] + self.user_arguments


def _which(binary: str) -> bool:
    import shutil
    return shutil.which(binary) is not None
