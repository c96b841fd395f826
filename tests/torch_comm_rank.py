"""One rank of ``tests/test_torch_comm.py``'s gloo groups, started by the
port's ``launcher/launch.py``: ``python tests/torch_comm_rank.py --out DIR
--mode pair|mesh4``. It imports no JAX; it writes its results as
``rank_<r>.npz`` (tensors) and ``rank_<r>.json`` (groups, logger records)
under ``DIR``, which the test holds against the JAX package.

``pair`` (2 ranks, mesh ``{"dp": 2}``): every case of :data:`CASES` on the
rank's cut of the seeded inputs, the comms logger on; gloo's native AVG,
``reduce_scatter_tensor`` and bf16 reduction. ``mesh4`` (4 ranks, mesh
``{"dp": 2, "tp": 2}``): each group's members and size, ``axis_index``,
``get_global_rank``, and a SUM and a gather over each group."""

import argparse
import json
import os
import sys

import numpy as np

N = 2            # ranks of the pair
SEED = 11
GROUPS = {"dp": "dp", "tp": "tp", "dp_tp": ("dp", "tp"), "tp_dp": ("tp", "dp"), "world": None}


def inputs():
    """The seeded inputs: ``x`` and ``p`` stacked over the ranks (JAX's
    eager layout), ``full`` scatter's source tensor."""
    r = np.random.default_rng(SEED)
    x = r.standard_normal((N, 4, 6)).astype(np.float32)
    sign = np.where(r.random((N, 4, 6)) < 0.4, -1.0, 1.0)
    p = (r.uniform(0.5, 2.0, (N, 4, 6)) * sign).astype(np.float32)
    full = r.standard_normal((4, 6)).astype(np.float32)
    return {"x": x, "p": p, "full": full}


# name -> (input, dtype, cut, call): ``cut`` is how a rank's tensor comes
# from the stacked input (``keep``: x[i:i+1], JAX's per-device shard;
# ``drop``: x[i], the per-rank tensor of JAX's reduce_scatter and
# all_to_all; ``src``: the full tensor plus 100 x rank, so only the
# source's survives); ``call`` names the collective and its arguments
CASES = {}
for _dt in ("fp32", "bf16"):
    for _op in ("SUM", "AVG", "MAX", "MIN", "PRODUCT"):
        CASES[f"all_reduce_{_op}_{_dt}"] = ("p" if _op == "PRODUCT" else "x", _dt, "keep",
                                            ("all_reduce", {"op": _op}))
    CASES[f"all_gather_{_dt}"] = ("x", _dt, "keep", ("all_gather", {}))
    CASES[f"reduce_scatter_{_dt}"] = ("x", _dt, "drop", ("reduce_scatter", {}))
    CASES[f"all_to_all_{_dt}"] = ("x", _dt, "drop", ("all_to_all_single", {}))
    CASES[f"broadcast_{_dt}"] = ("x", _dt, "keep", ("broadcast", {"src": 1}))
    CASES[f"ring_{_dt}"] = ("x", _dt, "keep", ("ring_send_recv", {"shift": 1}))
CASES.update({
    "inference_all_reduce": ("x", "fp32", "keep", ("inference_all_reduce", {})),
    "reduce_max": ("x", "fp32", "keep", ("reduce", {"op": "MAX"})),
    "all_gather_axis1": ("x", "fp32", "keep", ("all_gather", {"axis": 1})),
    "all_gather_stacked0": ("x", "fp32", "keep", ("all_gather", {"tiled": False})),
    "all_gather_stacked2": ("x", "fp32", "keep", ("all_gather", {"axis": 2, "tiled": False})),
    "gather_axis1": ("x", "fp32", "keep", ("gather", {"axis": 1})),
    "all_gather_into_tensor": ("x", "fp32", "keep", ("all_gather_into_tensor", {})),
    "reduce_scatter_axis1": ("x", "fp32", "drop", ("reduce_scatter", {"axis": 1})),
    "reduce_scatter_AVG": ("x", "fp32", "drop", ("reduce_scatter", {"op": "AVG"})),
    "reduce_scatter_MAX": ("x", "fp32", "drop", ("reduce_scatter", {"op": "MAX"})),
    "reduce_scatter_tensor": ("x", "fp32", "drop", ("reduce_scatter_tensor", {})),
    "all_to_all_split1": ("x", "fp32", "drop", ("all_to_all_single", {"split_axis": 1})),
    "all_to_all_concat1": ("x", "fp32", "drop", ("all_to_all_single", {"concat_axis": 1})),
    "broadcast_src0": ("x", "fp32", "keep", ("broadcast", {"src": 0})),
    "ring_back": ("x", "fp32", "keep", ("ring_send_recv", {"shift": -1})),
    "scatter_axis0": ("full", "fp32", "src", ("scatter", {"src": 1})),
    "scatter_axis1": ("full", "fp32", "src", ("scatter", {"src": 0, "axis": 1})),
})


def rank_input(arrays, case, rank):
    """Rank ``rank``'s tensor of ``case`` (fp32 numpy; the caller casts)."""
    key, _, cut, _ = CASES[case]
    a = arrays[key]
    if cut == "keep":
        return a[rank:rank + 1]
    if cut == "drop":
        return a[rank]
    return a + 100.0 * rank


def _pair(dist, torch, out, rank):
    arrays = inputs()
    dist.init_mesh({"dp": N})
    dist.configure(enabled=True, prof_all=True)
    results = {}
    for case, (_, dt, _, (fn, kw)) in CASES.items():
        t = torch.from_numpy(rank_input(arrays, case, rank).copy())
        t = t.to(torch.bfloat16) if dt == "bf16" else t
        kw = {k: getattr(dist.ReduceOp, v) if k == "op" else v for k, v in kw.items()}
        if fn in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            y = getattr(dist, fn)(None, t, **kw)
        else:
            y = getattr(dist, fn)(t, **kw)
        results[case] = y.float().numpy()
        # every call leaves its input as it was
        assert torch.equal(t.float(), torch.from_numpy(rank_input(arrays, case, rank)).to(
            t.dtype).float()), case
    barrier = dist.barrier()
    records = {name: {str(size): rec[0] for size, rec in sizes.items()}
               for name, sizes in dist.comms_logger().comms_dict.items()}
    dist.configure(enabled=False)

    # gloo's ops that the port calls natively: AVG, reduce_scatter_tensor
    # and a bf16 reduction, at the torch level
    import torch.distributed as tdist
    native = {}
    v = torch.tensor([1.0 + rank, 3.0], dtype=torch.bfloat16)
    tdist.all_reduce(v, op=tdist.ReduceOp.AVG)
    native["avg_bf16"] = v.float().tolist()
    rs = torch.empty(2)
    tdist.reduce_scatter_tensor(rs, torch.arange(4, dtype=torch.float32) * (rank + 1))
    native["reduce_scatter_tensor"] = rs.tolist()
    np.savez(os.path.join(out, f"rank_{rank}.npz"), barrier=barrier.numpy(), **results)
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump({"records": records, "native": native, "backend": tdist.get_backend(),
                   "world": dist.get_world_size(), "rank": dist.get_rank()}, f)


def _mesh4(dist, torch, out, rank):
    mesh = dist.init_mesh({"dp": 2, "tp": 2})
    rec = {"axis_index": {a: dist.axis_index(a) for a in ("dp", "tp")}, "groups": {}}
    for key, group in GROUPS.items():
        size = dist.get_world_size(group)
        axes = dist.comm._resolve_axes(group)
        total = dist.all_reduce(torch.tensor([float(rank)]), group=group)
        gathered = dist.all_gather(torch.tensor([float(rank)]), group=group)
        rec["groups"][key] = {
            "size": size, "members": mesh.slice_of(axes, rank),
            "global_ranks": [dist.get_global_rank(group, k) for k in range(size)],
            "sum": float(total[0]), "gathered": gathered.tolist()}
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("pair", "mesh4"), required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    import deepspeed_tpu_torch.comm as dist

    torch.set_num_threads(1)
    dist.init_distributed(dist_backend="gloo", verbose=False)
    rank = dist.get_rank()
    (_pair if args.mode == "pair" else _mesh4)(dist, torch, args.out, rank)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
