"""Collective micro-benchmarks (counterpart of
``deepspeed_tpu/benchmarks/comm_bench.py``; ``dscli bench``).

Sweeps message sizes through the comm facade's collectives over the world's
mesh and prints latency, algorithmic and bus bandwidth per op and size, with
the card's name and power limit. A message of ``size`` bytes is spread over
the ``n`` ranks: each holds its own ``[numel / n]`` fp32 tensor. Each trial
loop ends in a device synchronize.

Run under the launcher (``python -m deepspeed_tpu_torch.cli run
--num_gpus N -m ...``) for N ranks; a bare process benchmarks a world of
one rank on its own process group (nccl on the card, gloo with ``--device
cpu``).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import time
from typing import List

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast")


def _bw_factor(op: str, n: int) -> float:
    """algbw -> busbw correction factor (the ring-collective cost model)."""
    if n <= 1:
        return 1.0
    if op == "all_reduce":
        return 2.0 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0


def run_op(op: str, size_bytes: int, mesh, trials: int = 20, device=None) -> dict:
    """Time ``trials`` calls of ``op`` at ``size_bytes`` over ``mesh``'s
    ranks, after one warm-up call."""
    import torch

    import deepspeed_tpu_torch.comm as dist

    n = mesh.size
    numel = max(n, (size_bytes // 4 // n) * n)
    rank = dist.get_rank()
    per = numel // n
    x = torch.arange(rank * per, (rank + 1) * per, dtype=torch.float32, device=device)
    fns = {
        "all_reduce": lambda t: dist.all_reduce(t),
        "all_gather": lambda t: dist.all_gather(t),
        "reduce_scatter": lambda t: dist.reduce_scatter(t),
        "all_to_all": lambda t: dist.all_to_all_single(t),
        "broadcast": lambda t: dist.broadcast(t, src=0),
    }
    fn = fns[op]
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    fn(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(trials):
        fn(x)
    sync()
    dt = (time.perf_counter() - t0) / trials
    algbw = size_bytes / dt / 1e9
    return {"op": op, "size": size_bytes, "latency_us": dt * 1e6,
            "algbw_GBps": algbw, "busbw_GBps": algbw * _bw_factor(op, n)}


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the visible card(s)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv: List[str] = None):
    parser = argparse.ArgumentParser(description="collective micro-benchmarks")
    parser.add_argument("--ops", type=str, default=",".join(OPS))
    parser.add_argument("--minsize", type=int, default=1 << 12)
    parser.add_argument("--maxsize", type=int, default=1 << 26)
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (nccl, the default) or cpu (gloo)")
    args = parser.parse_args(argv)

    import torch

    import deepspeed_tpu_torch.comm as dist

    backend = "nccl" if args.device == "cuda" else "gloo"
    if any(v in os.environ for v in ("WORLD_SIZE", "NUM_PROCESSES", "COORDINATOR_ADDRESS")):
        dist.init_distributed(dist_backend=backend, verbose=False)
    else:
        os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
        dist.init_distributed(dist_backend=backend, rank=0, world_size=1, verbose=False)
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    if not dist.has_mesh():
        dist.init_mesh()
    mesh = dist.get_mesh()
    n = mesh.size
    if dist.get_rank() == 0:
        card = card_name_and_power() if args.device == "cuda" else "cpu"
        print(f"comm bench over mesh {mesh.shape} ({n} ranks, {backend}) on {card}")
        print(f"{'op':<16}{'size':>12}{'latency(us)':>14}{'algbw(GB/s)':>13}{'busbw(GB/s)':>13}")
    rows = []
    for op in args.ops.split(","):
        size = args.minsize
        while size <= args.maxsize:
            r = run_op(op, size, mesh, args.trials, device=device)
            rows.append(r)
            if dist.get_rank() == 0:
                print(f"{r['op']:<16}{r['size']:>12}{r['latency_us']:>14.1f}"
                      f"{r['algbw_GBps']:>13.3f}{r['busbw_GBps']:>13.3f}", flush=True)
            size *= 8
    dist.destroy_process_group()
    return rows


if __name__ == "__main__":
    main()
