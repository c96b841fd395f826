"""deepspeed_tpu_torch.comm — collectives over named mesh axes on
``torch.distributed`` (counterpart of ``deepspeed_tpu.comm``)::

    import deepspeed_tpu_torch.comm as dist
    dist.init_distributed()              # nccl; dist_backend="gloo" on the CPU
    dist.init_mesh({"dp": -1})
    y = dist.all_reduce(x, op=dist.ReduceOp.AVG, group="dp")
"""

from deepspeed_tpu_torch.comm.comm import (
    ReduceOp, all_gather, all_gather_flat, all_gather_into_tensor, all_reduce,
    all_reduce_in_place,
    all_to_all_single, axis_index, barrier, broadcast, comms_logger, configure,
    destroy_process_group, gather, get_global_rank, get_local_rank, get_mesh,
    get_rank, get_world_group, get_world_size, group_rank, has_mesh, has_process_group,
    inference_all_reduce, init_distributed, init_mesh, irecv, is_available,
    is_initialized, isend, log_summary, mesh_override, monitored_barrier, new_group,
    recv, reduce, reduce_scatter, reduce_scatter_flat, reduce_scatter_tensor,
    ring_send_recv, scatter,
    send, set_mesh)
from deepspeed_tpu_torch.comm.mesh import (Mesh, axis_size, build_hybrid_mesh, build_mesh,
                                           data_parallel_axes)

__all__ = [
    "ReduceOp", "all_gather", "all_gather_flat", "all_gather_into_tensor", "all_reduce", "all_reduce_in_place",
    "all_to_all_single", "has_process_group",
    "axis_index", "barrier", "broadcast", "comms_logger", "configure", "destroy_process_group",
    "gather", "get_global_rank", "get_local_rank", "get_mesh", "get_rank", "get_world_group",
    "get_world_size", "group_rank", "has_mesh", "inference_all_reduce", "init_distributed", "init_mesh",
    "irecv", "is_available", "is_initialized", "isend", "log_summary", "mesh_override",
    "monitored_barrier", "new_group", "recv", "reduce", "reduce_scatter", "reduce_scatter_flat",
    "reduce_scatter_tensor", "ring_send_recv", "scatter", "send", "set_mesh", "Mesh",
    "axis_size", "build_hybrid_mesh", "build_mesh", "data_parallel_axes",
]
