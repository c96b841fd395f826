"""The port's launcher (``launcher/``: ``runner.py``, ``launch.py``,
``multinode_runner.py``; ``dscli run`` and ``dscli ssh``) and ``dscli
bench`` on the CPU.

The host code is held to the JAX package's functions on the same inputs:
the hostfile parse, the include / exclude filter, the world info's
encoding, each rank's environment and the six multi-node runners' command
lines must be equal, apart from the listed CUDA substitutions
(``CUDA_VISIBLE_DEVICES`` for ``TPU_VISIBLE_CHIPS``, the port's launch
module, the exported prefixes). Then processes: ``launch.py`` stops every
rank when one exits non-zero, ``cli run`` starts one rank per
``DS_NUM_CHIPS`` slot with the rank environment, and ``cli bench`` runs
over one and two gloo ranks."""

import argparse
import json
import os
import sys
import time

import pytest
import torch

from deepspeed_tpu import cli as jax_cli
from deepspeed_tpu.launcher import launch as jlaunch
from deepspeed_tpu.launcher import multinode_runner as jmr
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu_torch import cli
from deepspeed_tpu_torch.launcher import launch as plaunch
from deepspeed_tpu_torch.launcher import multinode_runner as pmr
from deepspeed_tpu_torch.launcher import runner as prunner
from tests.torch_launch_util import ROOT, free_port, rank_env, run_launch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LAUNCH_MODULE = ("deepspeed_tpu.launcher.launch", "deepspeed_tpu_torch.launcher.launch")


def _both(fn, *args, **kw):
    """``fn`` of both packages on the same inputs: (result or error text)
    for each."""
    out = []
    for mod in (jrunner, prunner):
        try:
            out.append(("ok", getattr(mod, fn)(*args, **kw)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


HOSTFILES = {
    "plain": "worker-0 slots=2\nworker-1 slots=4\n",
    "comments": "# a cluster\n\nworker-0 slots=8\n  \n# end\nworker-1 slots=8\nworker-2 slots=1\n",
    "bad_format": "worker-0 slots2\n",
    "bad_key": "worker-0 gpus=2\n",
    "duplicate": "worker-0 slots=2\nworker-0 slots=2\n",
}


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_fetch_hostfile_equals_jax(name, tmp_path):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES[name])
    want, got = _both("fetch_hostfile", str(path))
    assert got == want
    assert _both("fetch_hostfile", str(tmp_path / "missing")) == [("ok", None)] * 2


POOL = {"worker-0": 4, "worker-1": 4, "worker-2": 2}
FILTERS = [("", ""), ("worker-1", ""), ("worker-0:0,2@worker-2", ""), ("", "worker-1"),
           ("", "worker-0:1,3@worker-2:0"), ("", "worker-2:0,1"), ("worker-0", "worker-1"),
           ("worker-9", ""), ("worker-0:7", ""), ("", "worker-9")]


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_resource_filter_equals_jax(include, exclude):
    want, got = _both("parse_resource_filter", dict(POOL), include, exclude)
    assert got == want
    assert prunner._parse_hostfile_filter(include or exclude) == \
        jrunner._parse_hostfile_filter(include or exclude)


@pytest.mark.parametrize("info", [{"localhost": [0]}, {"worker-0": [0, 1], "worker-1": [0, 2, 3]},
                                  {"a": list(range(8)), "b": list(range(8))}])
def test_world_info_roundtrip_equals_jax(info):
    enc = prunner.encode_world_info(info)
    assert enc == jrunner.encode_world_info(info)
    assert prunner.decode_world_info(enc) == jrunner.decode_world_info(enc) == info


@pytest.mark.parametrize("info,node,local", [({"localhost": [0, 1]}, 0, 1),
                                             ({"a": [0, 1], "b": [0, 1]}, 1, 1),
                                             ({"a": [2, 5], "b": [0, 1, 3]}, 1, 2),
                                             ({"a": [0], "b": [0], "c": [4]}, 2, 0)])
def test_rank_env_equals_jax_but_cuda_visible_devices(info, node, local):
    want = jlaunch.build_rank_env(info, node, local, "10.0.0.1", 29511)
    got = plaunch.build_rank_env(info, node, local, "10.0.0.1", 29511)
    want["CUDA_VISIBLE_DEVICES"] = want.pop("TPU_VISIBLE_CHIPS")
    assert got == want


def _args(**kw):
    ns = argparse.Namespace(hostfile="/job/hostfile", master_addr="worker-0", master_port=29500,
                            include="", exclude="", num_nodes=-1, user_script="train.py",
                            user_args=["--foo", "bar"], launcher_args="", save_pid=False,
                            enable_each_rank_log=None)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


RUNNERS = ["PDSHRunner", "OpenMPIRunner", "MPICHRunner", "MVAPICHRunner", "IMPIRunner",
           "SlurmRunner"]
RUNNER_ARGS = [{}, {"num_nodes": 2, "launcher_args": "--mca x y", "save_pid": True,
                    "enable_each_rank_log": "/logs", "include": "worker-0@worker-1"}]


@pytest.mark.parametrize("over", range(len(RUNNER_ARGS)))
@pytest.mark.parametrize("name", RUNNERS)
def test_runner_command_lines_equal_jax(name, over, tmp_path, monkeypatch):
    resources = {"worker-0": [0, 1], "worker-1": [0, 1]}
    cmds = []
    for mod in (jmr, pmr):
        cls = getattr(mod, name)
        monkeypatch.setattr(cls, "HOSTFILE", str(tmp_path / "hosts"), raising=False)
        runner = cls(_args(**RUNNER_ARGS[over]), "WORLDINFO")
        runner.add_export("DS_X", "y z")
        env = {}
        cmds.append((runner.get_cmd(env, resources), env, runner.name))
    (want, want_env, want_name), (got, got_env, got_name) = cmds
    want = [a.replace(*LAUNCH_MODULE) for a in want]
    assert got == want and got_env == want_env and got_name == want_name
    if name == "MVAPICHRunner":
        assert (tmp_path / "hosts").read_text().split() == ["worker-0", "worker-1"]
        with pytest.raises(ValueError, match="same number"):
            pmr.MVAPICHRunner(_args(), "W").get_cmd({}, {"worker-0": [0, 1], "worker-1": [0]})


def test_exported_prefixes_swap_tpu_for_cuda():
    swap = {"JAX_": "TORCH_", "LIBTPU": "NCCL_", "TPU_": "CUDA_", "XLA_": "PYTORCH_"}
    assert prunner.EXPORT_ENVS == [swap.get(p, p) for p in jrunner.EXPORT_ENVS]
    assert prunner.DLTS_HOSTFILE == jrunner.DLTS_HOSTFILE
    assert prunner.DEEPSPEED_ENVIRONMENT_NAME == jrunner.DEEPSPEED_ENVIRONMENT_NAME


def test_local_count_reads_ds_num_chips_then_cuda(monkeypatch):
    monkeypatch.setenv("DS_NUM_CHIPS", "3")
    assert prunner._local_chip_count() == jrunner._local_chip_count() == 3
    monkeypatch.delenv("DS_NUM_CHIPS")
    assert prunner._local_chip_count() == max(1, torch.cuda.device_count())


def test_ssh_command_equals_jax(tmp_path, monkeypatch):
    """``ssh``: without pdsh both raise the same error; with it, both run
    the same pdsh command over the hostfile's hosts."""
    import shutil
    import subprocess
    hostfile = tmp_path / "hostfile"
    hostfile.write_text(HOSTFILES["comments"])
    monkeypatch.setattr(shutil, "which", lambda b: None)
    with pytest.raises(RuntimeError) as got:
        cli.main(["ssh", "-f", str(hostfile), "hostname"])
    with pytest.raises(RuntimeError) as want:
        jax_cli._ssh(["-f", str(hostfile), "hostname"])
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(shutil, "which", lambda b: f"/usr/bin/{b}")
    calls = []
    monkeypatch.setattr(subprocess, "call", lambda argv, env: calls.append(
        (argv, env["PDSH_RCMD_TYPE"])) or 0)
    assert cli.main(["ssh", "-f", str(hostfile), "uname", "-a"]) == 0
    jax_cli._ssh(["-f", str(hostfile), "uname", "-a"])
    assert calls[0] == calls[1] == (["pdsh", "-w", "worker-0,worker-1,worker-2", "uname", "-a"],
                                    "ssh")


def test_launch_stops_every_rank_when_one_fails(tmp_path):
    """Rank 1 exits 3 while rank 0 sleeps: the launcher exits 3 within
    seconds and rank 0's process is gone (terminated and reaped)."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys, time\n"
        f"d = {str(tmp_path)!r}\n"
        "if os.environ['RANK'] == '1':\n"
        "    while not os.path.exists(os.path.join(d, 'pid_0')):\n"
        "        time.sleep(0.05)\n"
        "    sys.exit(3)\n"
        "open(os.path.join(d, 'pid_0.tmp'), 'w').write(str(os.getpid()))\n"
        "os.replace(os.path.join(d, 'pid_0.tmp'), os.path.join(d, 'pid_0'))\n"
        "time.sleep(60)\n")
    from deepspeed_tpu_torch.launcher.runner import encode_world_info
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="launch exited 3"):
        run_launch([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                    f"--world_info={encode_world_info({'localhost': [0, 1]})}",
                    f"--master_port={free_port()}", f"--enable_each_rank_log={tmp_path / 'logs'}",
                    str(script)], tmp_path / "logs", timeout=50)
    assert time.perf_counter() - t0 < 40
    pid = int((tmp_path / "pid_0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_cli_run_starts_a_rank_per_slot(tmp_path):
    """``cli run`` with ``DS_NUM_CHIPS=2``: two ranks through the runner and
    ``launch.py``, each with the rank environment of ``build_rank_env``
    and its own log."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import json, os\n"
        "keys = ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT',\n"
        "        'CUDA_VISIBLE_DEVICES', 'COORDINATOR_ADDRESS')\n"
        f"json.dump({{k: os.environ[k] for k in keys}}, open(os.path.join({str(tmp_path)!r}, "
        "'env_' + os.environ['RANK'] + '.json'), 'w'))\n"
        "print('rank', os.environ['RANK'], 'ran')\n")
    port = free_port()
    run_launch([sys.executable, "-m", "deepspeed_tpu_torch.cli", "run", f"--master_port={port}",
                f"--enable_each_rank_log={tmp_path / 'logs'}", str(script)], tmp_path / "logs",
               timeout=60, env=rank_env(DS_NUM_CHIPS="2"))
    for rank in (0, 1):
        env = json.loads((tmp_path / f"env_{rank}.json").read_text())
        want = plaunch.build_rank_env({"localhost": [0, 1]}, 0, rank, "127.0.0.1", port)
        assert env == {k: want[k] for k in env}
        assert env["RANK"] == env["LOCAL_RANK"] == env["CUDA_VISIBLE_DEVICES"] == str(rank)
        assert env["WORLD_SIZE"] == "2" and env["MASTER_ADDR"] == "127.0.0.1"
        assert env["MASTER_PORT"] == str(port) and env["COORDINATOR_ADDRESS"] == f"127.0.0.1:{port}"
        assert (tmp_path / "logs" / f"rank_{rank}.log").read_text().strip() == f"rank {rank} ran"


@pytest.mark.parametrize("ranks", [1, 2])
def test_cli_bench_runs_over_gloo_ranks(ranks, tmp_path):
    """``cli bench --device cpu`` in a bare process (a world of one rank on
    its own gloo group) and as the script of ``cli run`` over two ranks:
    rank 0 prints the table, a row per op and size."""
    args = ["--device", "cpu", "--minsize", "4096", "--maxsize", "32768", "--trials", "2"]
    if ranks == 1:
        cmd = [sys.executable, "-m", "deepspeed_tpu_torch.cli", "bench", *args]
        env = rank_env()
    else:
        cmd = [sys.executable, "-m", "deepspeed_tpu_torch.cli", "run", f"--master_port={free_port()}",
               str(ROOT / "deepspeed_tpu_torch" / "benchmarks" / "comm_bench.py"), *args]
        env = rank_env(DS_NUM_CHIPS=str(ranks))
    out = run_launch(cmd, tmp_path, timeout=90, env=env).stdout
    assert f"over mesh {{'dp': {ranks}}} ({ranks} ranks, gloo)" in out
    rows = [line.split() for line in out.splitlines() if line.split()[:1] and
            line.split()[0] in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                                "broadcast")]
    assert sorted((r[0], int(r[1])) for r in rows) == sorted(
        (op, size) for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                              "broadcast") for size in (4096, 32768))
    # latency in µs with one decimal; the bandwidths (3 decimals of GB/s)
    # can print 0.000 for a few KB on a loaded host
    assert all(float(r[2]) > 0 and float(r[3]) >= 0 and float(r[4]) >= 0 for r in rows)
