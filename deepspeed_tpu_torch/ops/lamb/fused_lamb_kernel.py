"""Fused LAMB: the CUDA kernels ``csrc/fused_lamb.cu`` (TPU K7) and their
plain PyTorch versions.

Replaces the TPU kernel ``deepspeed_tpu/ops/lamb/fused_lamb_kernel.py``
``_lamb_kernel``: Adam's moments and the unscaled update
``u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p``, with the trust ratio
``||p|| / ||u||`` (1 where either norm is 0) over one JAX leaf, then
``p - lr * (ratio * u)``. The JAX package stacks the layers into one
``[n_layer, ...]`` leaf, so its ratio spans every layer; the port keeps one
leaf per layer, so the unit here is a *group* of port leaves that form one
JAX leaf (:func:`lamb_group_step`, and the engine's update through
:class:`~deepspeed_tpu_torch.runtime.optimizers.Lamb`).

A step over a group is three kernels (see the source): :func:`lamb_moments`
per leaf (m, v in place; per-block partial sums of p² and u² into the
group's fp64 buffer), :func:`lamb_ratio` once (the ratio stays on the
device), :func:`lamb_apply` per leaf (u recomputed, ``p`` written in place).
What bounds them on the H100 is memory: 40 bytes an element over the two
passes against 28 for one pass that could keep u.

Unlike the JAX functions, which return new arrays, the port updates m, v and
(in the engine) p in place. Each wrapper takes the plain version for CPU
tensors only; for a CUDA tensor it launches its kernel or raises.
``moments_launches``, ``ratio_launches`` and ``apply_launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Union

import torch

from deepspeed_tpu_torch.ops.adam.fused_adam_kernel import _DTYPE_CODE, _check, bias_corrections
from deepspeed_tpu_torch.ops.kernels import build

#: kernel launches since the last reset (set them to 0 to start counting)
moments_launches = 0
ratio_launches = 0
apply_launches = 0

_THREADS = 256
_VEC = 8
_MAX_BLOCKS = 132 * 8


def lamb_blocks(n: int) -> int:
    """Blocks of a moments or apply launch over ``n`` elements (one slot of
    the partial buffer each): one thread per 8-element vector, at most
    eight blocks an SM."""
    work = n // _VEC + n % _VEC
    return max(1, min(-(-work // _THREADS), _MAX_BLOCKS))


def lamb_u_plain(p, m, v, bc1: float, bc2: float, eps: float, wd: float):
    """The unscaled update from the new moments, one fp32 op at a time
    (``(m / bc1) / (sqrt(v / bc2) + eps) + wd * p``; in place on temporaries,
    the same roundings)."""
    u = torch.div(m, bc1)
    den = torch.div(v, bc2).sqrt_().add_(eps)
    u.div_(den)
    if wd:
        u.add_(den.copy_(p).mul_(wd))
    return u


def _moments_plain(p, g, m, v, bc1, bc2, b1, b2, eps, wd):
    """New m, v (``b1 m + (1 - b1) g``, ``b2 v + (1 - b2) g²``) and u; pure."""
    g = g.float()
    m = torch.mul(m, b1).add_(torch.mul(g, 1.0 - b1))
    v = torch.mul(v, b2).add_(torch.mul(g, g).mul_(1.0 - b2))
    return m, v, lamb_u_plain(p, m, v, bc1, bc2, eps, wd)


def _sum_sq(x):
    """Σx² of an fp32 tensor: fp32 squares, a pairwise fp32 sum, as fp64."""
    return torch.sum(torch.square(x)).double()


def ratio_plain(p_sq, u_sq):
    """``||p|| / ||u||`` from the sums of squares (fp64), in fp32; 1 where
    either norm is 0."""
    pn = torch.sqrt(p_sq).float()
    un = torch.sqrt(u_sq).float()
    return torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))


def _plain_lamb_flat(p, g, m, v, lr: float, bc1: float, bc2: float, *, b1: float, b2: float,
                     eps: float, weight_decay: float):
    """One LAMB step on one flat leaf in plain PyTorch (the JAX
    ``_jnp_lamb_flat``). Pure: returns ``(new_p, m, v, ratio, u)``."""
    m, v, u = _moments_plain(p, g, m, v, bc1, bc2, b1, b2, eps, weight_decay)
    pf = p.float()
    ratio = ratio_plain(_sum_sq(pf), _sum_sq(u))
    new_p = (pf - lr * (ratio * u)).to(p.dtype)
    return new_p, m, v, ratio, u


def _fn(name, argtypes):
    fn = getattr(build.load("fused_lamb"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _check_device(p, *others):
    for name, x in others:
        if x.device != p.device:
            raise ValueError(f"{name} is on {x.device}, p on {p.device}")
    if not p.is_cuda and p.device.type != "cpu":
        raise ValueError(f"fused LAMB: no kernel for device {p.device}")


def lamb_moments(p, g, m, v, partials, *, bc1: float, bc2: float, b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """Pass 1 over one flat leaf: m and v (fp32) updated in place, and the
    leaf's ``[lamb_blocks(n), 2]`` slice ``partials`` (fp64) filled with the
    blocks' sums of p² and u² (the plain version puts the whole sum in row
    0)."""
    global moments_launches
    n = p.numel()
    _check_device(p, ("g", g), ("m", m), ("v", v), ("partials", partials))
    if tuple(partials.shape) != (lamb_blocks(n), 2) or partials.dtype != torch.float64:
        raise ValueError(f"partials must be fp64 [{lamb_blocks(n)}, 2], got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if not p.is_cuda:
        nm, nv, u = _moments_plain(p, g, m, v, bc1, bc2, b1, b2, eps, weight_decay)
        m.copy_(nm)
        v.copy_(nv)
        partials.zero_()
        partials[0, 0] = _sum_sq(p.float())
        partials[0, 1] = _sum_sq(u)
        return
    _check("p", p, n, tuple(_DTYPE_CODE))
    _check("g", g, n, tuple(_DTYPE_CODE))
    _check("m", m, n, (torch.float32,))
    _check("v", v, n, (torch.float32,))
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _fn("ds_lamb_moments", [P, I, P, I, P, P, ctypes.c_long, I, P] + [F] * 8 + [P])
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), _DTYPE_CODE[p.dtype], g.data_ptr(), _DTYPE_CODE[g.dtype],
                m.data_ptr(), v.data_ptr(), n, lamb_blocks(n), partials.data_ptr(), bc1, bc2,
                b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay, _stream(p))
    _raise_on(rc, "lamb_moments")
    moments_launches += 1


def lamb_ratio(partials, unorm=None) -> torch.Tensor:
    """The trust ratio of a group from its partial buffer ``[k, 2]``
    (fp64): a 0-dim fp32 tensor on the buffer's device. ``unorm``: None, or
    a one-element fp32 tensor that receives ``ratio * ||u||``, the norm of
    the group's applied direction (the update norm over lr)."""
    global ratio_launches
    if partials.dim() != 2 or partials.shape[1] != 2 or partials.dtype != torch.float64:
        raise ValueError(f"partials must be fp64 [k, 2], got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    if not partials.is_cuda:
        if partials.device.type != "cpu":
            raise ValueError(f"fused LAMB: no kernel for device {partials.device}")
        s = partials.sum(0)
        ratio = ratio_plain(s[0], s[1])
        if unorm is not None:
            unorm.view(()).copy_(ratio * torch.sqrt(s[1]).float())
        return ratio
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    if unorm is not None and (unorm.numel() != 1 or unorm.dtype != torch.float32
                              or unorm.device != partials.device):
        raise ValueError("unorm must be one fp32 value on the partials' device")
    ratio = torch.empty((), dtype=torch.float32, device=partials.device)
    P = ctypes.c_void_p
    fn = _fn("ds_lamb_ratio", [P, ctypes.c_int, P, P, P])
    with torch.cuda.device(partials.device):
        rc = fn(partials.data_ptr(), partials.shape[0], ratio.data_ptr(),
                None if unorm is None else unorm.data_ptr(), _stream(partials))
    _raise_on(rc, "lamb_ratio")
    ratio_launches += 1
    return ratio


def lamb_apply(p, m, v, ratio, *, lr: float, bc1: float, bc2: float, eps: float,
               weight_decay: float) -> None:
    """Pass 2 over one flat leaf: ``p <- p - lr * (ratio * u)`` in place,
    with u recomputed from the new m, v and p; ``ratio`` the group's device
    scalar."""
    global apply_launches
    n = p.numel()
    _check_device(p, ("m", m), ("v", v), ("ratio", ratio))
    if not p.is_cuda:
        step = lamb_u_plain(p, m, v, bc1, bc2, eps, weight_decay).mul_(ratio).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p.float().sub_(step))
        return
    _check("p", p, n, tuple(_DTYPE_CODE))
    _check("m", m, n, (torch.float32,))
    _check("v", v, n, (torch.float32,))
    if ratio.numel() != 1 or ratio.dtype != torch.float32:
        raise ValueError("ratio must be one fp32 value")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _fn("ds_lamb_apply", [P, I, P, P, ctypes.c_long, I, P] + [F] * 5 + [P])
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), _DTYPE_CODE[p.dtype], m.data_ptr(), v.data_ptr(), n,
                lamb_blocks(n), ratio.data_ptr(), lr, bc1, bc2, eps, weight_decay, _stream(p))
    _raise_on(rc, "lamb_apply")
    apply_launches += 1


GradSource = Union[Sequence[torch.Tensor], Callable[[int], torch.Tensor]]


def lamb_group_step(ps: List[torch.Tensor], grads: GradSource, ms: List[torch.Tensor],
                    vs: List[torch.Tensor], *, step, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                    bias_correction: bool = True, unorm=None, reduce=None,
                    device=None) -> torch.Tensor:
    """One LAMB step over the flat leaves ``ps`` of one JAX leaf, all in
    place (p, m, v); one trust ratio over the group, returned as a device
    scalar. ``grads``: the flat gradients, or a function of the leaf's
    index that returns it (so that only one is alive at a time).
    ``unorm``: see :func:`lamb_ratio`. ``reduce``: maps the moments' fp64
    partial buffer to the one the ratio reads (ZeRO: the sums over the
    ranks that hold parts of the JAX leaf, ``ps`` this rank's parts, maybe
    none; ``device`` then names the device)."""
    bc1, bc2 = bias_corrections(step, b1, b2, bias_correction)
    kw = dict(bc1=bc1, bc2=bc2, eps=float(eps), weight_decay=float(weight_decay))
    grad = grads if callable(grads) else grads.__getitem__
    blocks = [lamb_blocks(p.numel()) for p in ps]
    partials = torch.empty((sum(blocks), 2), dtype=torch.float64,
                           device=device if device is not None else ps[0].device)
    start = 0
    for i, (p, m, v) in enumerate(zip(ps, ms, vs)):
        lamb_moments(p, grad(i), m, v, partials[start:start + blocks[i]], b1=float(b1),
                     b2=float(b2), **kw)
        start += blocks[i]
    if reduce is not None:
        partials = reduce(partials)
    ratio = lamb_ratio(partials, unorm)
    for p, m, v in zip(ps, ms, vs):
        lamb_apply(p, m, v, ratio, lr=float(lr), **kw)
    return ratio


def fused_lamb_step(p, g, m, v, *, step, lr: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-6, weight_decay: float = 0.0, bias_correction: bool = True):
    """One fused LAMB step on flat 1-D buffers (the counterpart of the JAX
    ``fused_lamb_step``): returns ``(new_p, m, v, ratio)`` with m, v (fp32)
    updated in place, ``new_p`` a new tensor in p's dtype and ``ratio`` a
    0-dim fp32 tensor."""
    new_p = p.clone()
    ratio = lamb_group_step([new_p], [g], [m], [v], step=step, lr=lr, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay, bias_correction=bias_correction)
    return new_p, m, v, ratio


__all__ = ["fused_lamb_step", "lamb_group_step", "lamb_moments", "lamb_ratio", "lamb_apply",
           "lamb_blocks", "_plain_lamb_flat"]
