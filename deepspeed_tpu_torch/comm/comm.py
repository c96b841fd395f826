"""Communication facade over ``torch.distributed`` (counterpart of
``deepspeed_tpu/comm/comm.py``).

- **Groups are mesh axes.** A group is a named axis (or tuple of axes) of
  the framework mesh (``comm/mesh.py``); the calling rank's slice along it
  is one ``torch.distributed`` process group, created on first use by
  every rank together. A rank's index in a group is its position in the
  slice, row-major over the axes as given (JAX's order), which the data
  movers keep whatever order ``torch.distributed`` numbers the group in.

- **Each rank passes its own tensor.** JAX's eager calls take the
  stacked-rank global array (leading dim = ranks of the group); here, as in
  ``torch.distributed`` and the reference DeepSpeed, each rank passes its
  own slice and gets back its own slice of JAX's result: rank ``i`` of the
  group holds slice ``i``, or the whole result where JAX's is replicated
  (``all_gather``). With a process group every call returns a new tensor
  and leaves its input as it was, as the JAX calls do
  (``all_reduce_in_place`` excepted).

- **No process group, no backend.** Without ``init_distributed`` having
  made a process group, a collective returns its input (a world of one
  rank). With one, every collective calls the backend, over a group of one
  rank too.

- ``ReduceOp.PRODUCT`` is JAX's sign-aware formula through two SUM
  reductions: ``exp`` of the summed ``log |x|``, signed by the parity of
  the summed negative count. ``reduce_scatter`` sums (``AVG`` divides the
  sum by the group's size), as JAX's ``psum_scatter`` does for every op.
  The other ops run natively on either backend: gloo (torch 2.13) has
  ``AVG``, ``reduce_scatter_tensor`` and bf16 reductions, so nothing is
  built from SUM for it.
"""

from __future__ import annotations

import datetime
import functools
import os
import time
from enum import Enum
from typing import Optional, Sequence, Tuple, Union

import torch

from deepspeed_tpu_torch.utils import comms_logging
from deepspeed_tpu_torch.utils.logging import logger, warn_once

_mesh = None  # the framework-wide mesh, set by init_mesh/set_mesh
_mesh_tls = None  # lazy threading.local: per-thread mesh-override stack
_comms_logger = None
_initialized = False


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4
    UNUSED = 5


GroupLike = Union[None, str, Sequence[str]]


def _dist():
    import torch.distributed as dist
    return dist


def has_process_group() -> bool:
    """Whether a ``torch.distributed`` process group exists (collectives
    then call the backend)."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()




def comms_logger() -> comms_logging.CommsLogger:
    global _comms_logger
    if _comms_logger is None:
        _comms_logger = comms_logging.CommsLogger()
    return _comms_logger


def configure(deepspeed_config=None, enabled=None, prof_all=None, prof_ops=None, verbose=None,
              debug=None) -> None:
    """Wire the comms logger's settings from a training config."""
    cl = comms_logger()
    if deepspeed_config is not None:
        cl.configure(deepspeed_config.comms_config)
    if enabled is not None:
        cl.enabled = enabled
    if prof_all is not None:
        cl.prof_all = prof_all
    if prof_ops is not None:
        cl.prof_ops = prof_ops
    if verbose is not None:
        cl.verbose = verbose
    if debug is not None:
        cl.debug = debug


# --------------------------------------------------------------------- #
# Mesh / group management

def set_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def _mesh_override():
    """The current thread's innermost mesh override, or None."""
    tls = _mesh_tls
    stack = getattr(tls, "stack", None) if tls is not None else None
    return stack[-1] if stack else None


def mesh_override(mesh):
    """Context manager pinning :func:`get_mesh` / :func:`has_mesh` to
    ``mesh`` for the current thread only (re-entrant: a stack). The global
    mesh is not touched: other threads keep seeing it."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        global _mesh_tls
        if mesh is None:
            raise ValueError("mesh_override needs a mesh (None would "
                             "shadow the global instead of pinning one)")
        if _mesh_tls is None:
            import threading
            _mesh_tls = threading.local()
        stack = getattr(_mesh_tls, "stack", None)
        if stack is None:
            stack = _mesh_tls.stack = []
        stack.append(mesh)
        try:
            yield mesh
        finally:
            stack.pop()
    return scope()


def get_mesh():
    ov = _mesh_override()
    if ov is not None:
        return ov
    global _mesh
    if _mesh is None:
        from deepspeed_tpu_torch.comm.mesh import build_mesh
        _mesh = build_mesh()
    return _mesh


def has_mesh() -> bool:
    return _mesh_override() is not None or _mesh is not None


def init_mesh(axes=None, ranks=None):
    from deepspeed_tpu_torch.comm.mesh import build_mesh
    set_mesh(build_mesh(axes, ranks))
    return _mesh


def _resolve_axes(group: GroupLike) -> tuple:
    """Group -> the tuple of its axes present in the mesh. None = every
    axis. Axes missing from the mesh are dropped (a size-1 group)."""
    mesh = get_mesh()
    if group is None:
        return tuple(mesh.axis_names)
    axes = (group,) if isinstance(group, str) else tuple(group)
    for a in axes:
        if a not in mesh.shape:
            warn_once(f"Collective group axis '{a}' is not in the mesh {tuple(mesh.axis_names)}; "
                      f"treating as a size-1 group (no-op). Check for typos if this is unexpected.")
    return tuple(a for a in axes if a in mesh.shape)


def _group(axes: Tuple[str, ...]):
    """``(process group, members)`` of the calling rank's slice along
    ``axes``: members are global ranks in group order. The first use of an
    axes tuple creates a process group for every slice along it, in the
    same order on every rank (``new_group`` is collective)."""
    dist = _dist()
    mesh = get_mesh()
    hit = mesh.groups.get(axes)
    if hit is None:
        me = dist.get_rank()
        slices = mesh.slices(axes)
        if len(slices) == 1 and sorted(slices[0]) == list(range(dist.get_world_size())):
            hit = (dist.group.WORLD, slices[0])
        else:
            for members in slices:
                pg = dist.new_group(sorted(members))
                if me in members:
                    hit = (pg, members)
        mesh.groups[axes] = hit
    return hit


def _torch_order(members):
    """For each group index, the member's rank in the torch process group
    (``new_group`` numbers members in ascending global rank)."""
    ranked = sorted(members)
    return [ranked.index(r) for r in members]


def get_world_size(group: GroupLike = None) -> int:
    from deepspeed_tpu_torch.comm.mesh import axis_size
    return axis_size(get_mesh(), _resolve_axes(group))


def get_rank(group: GroupLike = None) -> int:
    """This process's global rank (JAX: ``process_index``); the position on
    a mesh axis is :func:`axis_index`."""
    return _dist().get_rank() if has_process_group() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` of the mesh."""
    return get_mesh().coords(get_rank())[axis]


# --------------------------------------------------------------------- #
# init_distributed

def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank: int = -1,
                     world_size: int = -1) -> None:
    """Create the process group (counterpart of the JAX
    ``init_distributed``, which starts ``jax.distributed``).

    The world is discovered as in the JAX package: ``rank`` / ``world_size``
    when given, else torch-style ``RANK`` / ``WORLD_SIZE`` (or
    ``PROCESS_ID`` / ``NUM_PROCESSES``), else OpenMPI, SLURM (``srun``
    steps of more than one task) or PMI variables; the address is
    ``COORDINATOR_ADDRESS``, else ``MASTER_ADDR:MASTER_PORT``, else SLURM's
    launch node. A bare process, with none of them, creates nothing and its
    collectives return their input. Where the world is given, the group is
    created at world size 1 too (the JAX runtime starts only above one
    process), so one rank on one card runs its collectives through NCCL.

    ``dist_backend`` defaults to ``"nccl"``, which needs a CUDA device and
    raises without one; ``"gloo"`` runs on the CPU only when asked for. A
    process group made elsewhere (``torch.distributed.init_process_group``)
    is adopted as it is. A call after a bare one looks at the world again,
    so a later call with ``rank`` / ``world_size`` still creates the group."""
    global _initialized
    if has_process_group():
        _initialized = True
        return
    dist = _dist()
    env = os.environ
    coord = env.get("COORDINATOR_ADDRESS")
    launched = world_size > 0 or rank >= 0 or coord is not None or \
        any(v in env for v in ("WORLD_SIZE", "NUM_PROCESSES"))
    nproc = world_size if world_size > 0 else int(env.get("WORLD_SIZE", env.get("NUM_PROCESSES", 1)))
    proc_id = rank if rank >= 0 else int(env.get("RANK", env.get("PROCESS_ID", 0)))

    # mpirun / srun set their own variables instead of RANK / WORLD_SIZE
    if auto_mpi_discovery and nproc <= 1 and not launched:
        if "OMPI_COMM_WORLD_SIZE" in env:
            nproc = int(env["OMPI_COMM_WORLD_SIZE"])
            proc_id = int(env.get("OMPI_COMM_WORLD_RANK", 0))
            launched = True
        elif int(env.get("SLURM_STEP_NUM_TASKS", 0)) > 1:
            # srun sets step-level task counts; a plain sbatch script, whose
            # single process must not join a phantom world, does not
            nproc = int(env["SLURM_STEP_NUM_TASKS"])
            proc_id = int(env.get("SLURM_PROCID", 0))
            launched = True
        elif "PMI_SIZE" in env:
            nproc = int(env["PMI_SIZE"])
            proc_id = int(env.get("PMI_RANK", 0))
            launched = True

    if not launched:
        if verbose:
            logger.info("Single-process run; no process group created")
        _initialized = True
        return

    if coord is None and "MASTER_ADDR" in env:
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', distributed_port)}"
    if coord is None and "SLURM_LAUNCH_NODE_IPADDR" in env:
        coord = f"{env['SLURM_LAUNCH_NODE_IPADDR']}:{distributed_port}"
    if coord is None:
        coord = f"127.0.0.1:{distributed_port}"
    backend = (dist_backend or "nccl").lower()
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the nccl backend needs a CUDA device and "
                               "torch.cuda.is_available() is false; pass dist_backend='gloo' "
                               "to run on the CPU")
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if verbose:
        logger.info(f"Initializing torch.distributed ({backend}): {coord} rank {proc_id}/{nproc}")
    set_mesh(None)          # a mesh built before the world existed spans one rank
    dist.init_process_group(backend, init_method=init_method or f"tcp://{coord}",
                            rank=proc_id, world_size=nproc,
                            **({"timeout": timeout} if timeout is not None else {}))
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def _device() -> torch.device:
    """The device the backend moves: the current CUDA device for nccl,
    the CPU for gloo (and without a process group)."""
    if has_process_group() and _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# --------------------------------------------------------------------- #
# Collective implementations

def _sync(t) -> None:
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _log_wrap(name: str, group_pos: int = 0, per_rank_divisor: bool = False):
    """Time the call and record its bandwidth while the comms logger is on.
    ``group_pos`` is the index of ``group`` among the positional arguments
    after the tensor. The message size is the rank's own tensor (JAX's
    stacked array over the group's size); ``per_rank_divisor`` divides it by
    the group's size where JAX's input is not stacked (``scatter``)."""

    def decorator(fn):

        @functools.wraps(fn)
        def wrapper(tensor, *args, **kwargs):
            cl = comms_logger()
            log_name = kwargs.pop("log_name", name)
            if not (cl.enabled and (cl.prof_all or name in cl.prof_ops)):
                return fn(tensor, *args, **kwargs)
            _sync(tensor)
            t0 = time.perf_counter()
            result = fn(tensor, *args, **kwargs)
            _sync(result)
            ms = (time.perf_counter() - t0) * 1e3
            group = kwargs.get("group", args[group_pos] if len(args) > group_pos else None)
            n = max(1, get_world_size(group))
            msg_size = tensor.numel() * tensor.element_size()
            if per_rank_divisor:
                msg_size //= n
            cl.append(name, log_name, ms, msg_size, n)
            return result

        return wrapper

    return decorator


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN", ReduceOp.AVG: "AVG"}


def _reduce_in_place(t: torch.Tensor, op: ReduceOp, pg) -> torch.Tensor:
    dist = _dist()
    if op == ReduceOp.PRODUCT:
        # sign-aware product: |prod| via the summed logs, sign via the
        # negative count's parity
        magnitude = torch.log(torch.abs(t))
        dist.all_reduce(magnitude, op=dist.ReduceOp.SUM, group=pg)
        neg_count = (t < 0).to(t.dtype)
        dist.all_reduce(neg_count, op=dist.ReduceOp.SUM, group=pg)
        sign = 1.0 - 2.0 * torch.remainder(neg_count, 2)
        return t.copy_(sign * torch.exp(magnitude))
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _TORCH_OPS[op]), group=pg)
    return t


@_log_wrap("all_reduce", group_pos=1)
def all_reduce(tensor, op: ReduceOp = ReduceOp.SUM, group: GroupLike = None,
               async_op: bool = False):
    """Reduce across the group; every member gets the result."""
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    pg, _ = _group(axes)
    return _reduce_in_place(tensor.clone(), op, pg)


@_log_wrap("all_reduce", group_pos=1)
def all_reduce_in_place(tensor, op: ReduceOp = ReduceOp.SUM, group: GroupLike = None):
    """:func:`all_reduce` into ``tensor`` itself, with no copy (the
    training engine's gradient average over its flat buffer)."""
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    pg, _ = _group(axes)
    return _reduce_in_place(tensor, op, pg)


def inference_all_reduce(tensor, op: ReduceOp = ReduceOp.SUM, group: GroupLike = None,
                         async_op: bool = False):
    return all_reduce(tensor, op=op, group=group)


def _gathered(tensor, axes):
    """Every member's tensor, in group order."""
    dist = _dist()
    pg, members = _group(axes)
    t = tensor.contiguous().reshape(-1)
    out = torch.empty(len(members) * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=pg)
    out = out.view((len(members),) + tuple(tensor.shape))
    return [out[j] for j in _torch_order(members)]


@_log_wrap("all_gather", group_pos=0)
def all_gather(tensor, group: GroupLike = None, axis: int = 0, tiled: bool = True,
               async_op: bool = False):
    """Gather every member's tensor along ``axis``: concatenated
    (``tiled``, the layout of the reference's ``all_gather_into_tensor``) or
    stacked on a new ``axis``. Every member gets the whole result."""
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    parts = _gathered(tensor, axes)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def all_gather_into_tensor(output_tensor=None, tensor=None, group: GroupLike = None,
                           async_op: bool = False):
    """Fused-tensor all-gather; with ``output_tensor`` the result is also
    written into it."""
    out = all_gather(tensor, group=group)
    if output_tensor is not None:
        output_tensor.copy_(out)
    return out


@_log_wrap("reduce_scatter", group_pos=1)
def reduce_scatter(tensor, op: ReduceOp = ReduceOp.SUM, group: GroupLike = None, axis: int = 0,
                   async_op: bool = False):
    """Sum across the group, then member ``i`` keeps chunk ``i`` of the sum
    along ``axis`` (``AVG``: divided by the group's size)."""
    dist = _dist()
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    pg, members = _group(axes)
    n = len(members)
    x = tensor.movedim(axis, 0)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: axis {axis} size {x.shape[0]} not divisible by "
                         f"group size {n}")
    chunks = x.chunk(n)
    placed = [None] * n
    for i, j in enumerate(_torch_order(members)):
        placed[j] = chunks[i]
    out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(out, torch.cat(placed), op=dist.ReduceOp.SUM, group=pg)
    if op == ReduceOp.AVG:
        out = out / get_world_size(group)
    return out.movedim(0, axis)


def group_rank(group: GroupLike = None) -> int:
    """This rank's index in the torch process group of its slice along
    ``group`` (members numbered by ascending global rank): the block that a
    flat partition gives it (:func:`all_gather_flat`). 0 without a process
    group."""
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return 0
    pg, _ = _group(axes)
    return _dist().get_rank(pg)


@_log_wrap("all_gather", group_pos=1)
def all_gather_flat(tensor, out, group: GroupLike = None):
    """``out`` (``n * tensor.numel()`` elements, contiguous) gets every
    member's 1-D ``tensor`` in :func:`group_rank` order, with no copy
    through a temporary: the ZeRO engine's refresh and gather of a flat
    unit. Returns ``out``."""
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return out.copy_(tensor.reshape(out.shape))
    pg, _ = _group(axes)
    _dist().all_gather_into_tensor(out, tensor, group=pg)
    return out


@_log_wrap("reduce_scatter", group_pos=1)
def reduce_scatter_flat(tensor, out, group: GroupLike = None):
    """The sum over the group of every member's 1-D ``tensor``, of which
    ``out`` gets block :func:`group_rank` (``tensor.numel() / n``
    elements): the ZeRO engine's gradient reduction into a rank's
    partition. Returns ``out``."""
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return out.copy_(tensor.reshape(out.shape))
    pg, _ = _group(axes)
    _dist().reduce_scatter_tensor(out, tensor, op=_dist().ReduceOp.SUM, group=pg)
    return out


def reduce_scatter_tensor(output_tensor=None, tensor=None, op: ReduceOp = ReduceOp.SUM,
                          group: GroupLike = None, async_op: bool = False):
    out = reduce_scatter(tensor, op=op, group=group)
    if output_tensor is not None:
        output_tensor.copy_(out)
    return out


@_log_wrap("all_to_all", group_pos=0)
def all_to_all_single(tensor, group: GroupLike = None, split_axis: int = 0, concat_axis: int = 0,
                      async_op: bool = False):
    """Split the tensor into group-size chunks along ``split_axis``; chunk
    ``j`` goes to member ``j``, and the chunks received are concatenated
    along ``concat_axis`` in member order (the MoE dispatch primitive)."""
    dist = _dist()
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    pg, members = _group(axes)
    n = len(members)
    chunks = tensor.chunk(n, dim=split_axis)
    if len(chunks) != n or tensor.shape[split_axis] % n:
        raise ValueError(f"all_to_all_single: axis {split_axis} size "
                         f"{tensor.shape[split_axis]} not divisible by group size {n}")
    order = _torch_order(members)
    placed = [None] * n
    for i, j in enumerate(order):
        placed[j] = chunks[i]
    inp = torch.stack(placed)
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=pg)
    return torch.cat([out[j] for j in order], dim=concat_axis)


@_log_wrap("broadcast", group_pos=1)
def broadcast(tensor, src: int = 0, group: GroupLike = None, async_op: bool = False):
    """Every member gets member ``src``'s tensor (``src`` a group index)."""
    dist = _dist()
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    pg, members = _group(axes)
    out = tensor.clone()
    dist.broadcast(out, src=members[src], group=pg)
    return out


@_log_wrap("ppermute", group_pos=1)
def ring_send_recv(tensor, shift: int = 1, group: GroupLike = None):
    """Neighbour exchange over the group's ring (the SPMD form of pipeline
    send / recv): member ``i`` sends to ``(i + shift) % n`` and receives
    from ``(i - shift) % n``."""
    dist = _dist()
    axes = _resolve_axes(group)
    if not axes or not has_process_group():
        return tensor
    pg, members = _group(axes)
    n = len(members)
    if shift % n == 0:
        # every member sends to itself: the identity permutation, a copy (a
        # rank cannot send to itself over gloo)
        return tensor.clone()
    i = members.index(dist.get_rank())
    t = tensor.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, members[(i + shift) % n], group=pg),
           dist.P2POp(dist.irecv, out, members[(i - shift) % n], group=pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def send(tensor, dst: int, group: GroupLike = None, tag: int = 0):
    raise NotImplementedError(
        "Point-to-point send/recv between arbitrary ranks is not an SPMD primitive; "
        "use ring_send_recv (ppermute) or the pipeline engine's stage transfer.")


def recv(tensor, src: int, group: GroupLike = None, tag: int = 0):
    raise NotImplementedError(
        "Point-to-point send/recv between arbitrary ranks is not an SPMD primitive; "
        "use ring_send_recv (ppermute) or the pipeline engine's stage transfer.")


def barrier(group: GroupLike = None, async_op: bool = False):
    """Synchronize the group: a one-element all-reduce that every member
    must join, waited for on the host."""
    x = all_reduce(torch.zeros((1,), dtype=torch.float32, device=_device()), group=group)
    _sync(x)
    return x


def monitored_barrier(group: GroupLike = None, timeout=None, wait_all_ranks: bool = False):
    return barrier(group)


def get_data_parallel_world_size():
    from deepspeed_tpu_torch.comm.mesh import data_parallel_axes
    return get_world_size(data_parallel_axes(get_mesh()))


def get_model_parallel_world_size():
    return get_world_size("tp") if "tp" in get_mesh().shape else 1


def log_summary(show_straggler: bool = False):
    return comms_logger().log_all(print_log=True, show_straggler=show_straggler)


# ------------------------------------------------------------------ #
# The rest of the reference surface. Rooted collectives (reduce / gather
# with a dst) give the result to every member, as the JAX package's do;
# the dst / src arguments are accepted for call-shape parity.

def is_available() -> bool:
    return _dist().is_available()


def get_world_group() -> GroupLike:
    """The world "process group": the all-axes GroupLike (None)."""
    return None


def reduce(tensor, dst: int = 0, op: ReduceOp = ReduceOp.SUM, group: GroupLike = None,
           async_op: bool = False):
    """Rooted reduce: every member holds the reduced value."""
    return all_reduce(tensor, op=op, group=group, async_op=async_op)


def gather(tensor, gather_list=None, dst: int = 0, group: GroupLike = None, axis: int = 0,
           async_op: bool = False):
    """Rooted gather: every member holds the gathered tensor."""
    return all_gather(tensor, group=group, axis=axis, async_op=async_op)


@_log_wrap("scatter", group_pos=1, per_rank_divisor=True)
def scatter(tensor, src: int = 0, group: GroupLike = None, axis: int = 0, async_op: bool = False):
    """Member ``src``'s tensor split along ``axis``: member ``i`` gets
    chunk ``i`` (the JAX eager call reshards the array so; each device's
    local view is its chunk)."""
    dist = _dist()
    axes = _resolve_axes(group)
    if not axes:
        return tensor
    ws = get_world_size(group)
    if tensor.shape[axis] % ws:
        raise ValueError(f"scatter: axis {axis} size {tensor.shape[axis]} "
                         f"not divisible by group size {ws}")
    if not has_process_group():
        return tensor
    pg, members = _group(axes)
    full = tensor.clone()
    dist.broadcast(full, src=members[src], group=pg)
    i = members.index(dist.get_rank())
    return full.chunk(ws, dim=axis)[i].contiguous()


def get_global_rank(group: GroupLike = None, group_rank: int = 0) -> int:
    """Translate a group index to the global rank: the group's axes take
    ``group_rank``'s coordinates, the other axes this rank's own."""
    mesh = get_mesh()
    axes = _resolve_axes(group)
    gsize = 1
    for name in axes:
        gsize *= mesh.shape[name]
    if not 0 <= group_rank < gsize:
        raise ValueError(f"group_rank {group_rank} out of range for group "
                         f"{axes} of size {gsize}")
    coords = mesh.coords(get_rank())
    rem = group_rank
    for name in reversed(axes):
        coords[name] = rem % mesh.shape[name]
        rem //= mesh.shape[name]
    return int(mesh.ranks[tuple(coords[n] for n in mesh.axis_names)])


def new_group(ranks=None):
    """The world list is the world group; any other subset must be a mesh
    axis (build the mesh with that axis and pass its name as the group)."""
    if ranks is None or sorted(ranks) == list(range(get_world_size())):
        return None
    raise NotImplementedError(
        "arbitrary rank subsets are not representable as mesh collectives; "
        "declare the grouping as a mesh axis (config mesh={...}) and pass "
        "the axis name as the group")


def destroy_process_group(group: GroupLike = None) -> None:
    """Clearing the world group drops the mesh (with its process groups)
    and destroys the process group, after which :func:`init_distributed`
    may run again."""
    global _initialized
    if group is not None:
        return
    set_mesh(None)
    if has_process_group():
        _dist().destroy_process_group()
    _initialized = False


class _CompletedWork:
    """Handle returned by isend / irecv."""

    def __init__(self, result=None):
        self.result = result

    def wait(self, timeout=None) -> bool:
        return True

    def is_completed(self) -> bool:
        return True


def isend(tensor, dst: int, group: GroupLike = None, tag: int = 0):
    """Async send: raises as :func:`send` does."""
    return _CompletedWork(send(tensor, dst, group=group, tag=tag))


def irecv(tensor, src: int, group: GroupLike = None, tag: int = 0):
    """Async recv: raises as :func:`recv` does."""
    return _CompletedWork(recv(tensor, src, group=group, tag=tag))
