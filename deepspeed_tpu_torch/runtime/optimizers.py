"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

The engine-built optimizers keep the JAX engine's update: ``master <- master
- lr * u`` with ``u`` the positive descent direction and ``lr`` the engine's
scheduled lr (``runtime/engine.py _apply_update``).

- ``adam``, ``adamw`` and ``fusedadam`` share one :class:`Adam`
  (``optax.scale_by_adam`` and the fused kernel compute the same function),
  which runs kernel E on the card (the port of the TPU's Pallas
  ``_adam_kernel``) with the subtraction fused in (``emit="param"``, the same
  two fp32 roundings as ``master - lr * u``); they differ only in how weight
  decay applies.
- ``lamb`` and ``fusedlamb`` share one :class:`Lamb` (optax ``scale_by_adam``
  + ``add_decayed_weights`` + ``scale_by_trust_ratio`` and the fused kernel
  compute the same function, with no clamp on the ratio), which runs the K7
  kernels on the card. Its trust ratio spans one JAX leaf, so the engine
  hands it each group of per-layer leaves at once (``group_update``).
- ``sgd`` (optax ``trace``), ``lion`` (``scale_by_lion``) and ``adagrad``
  (``scale_by_rss``), each followed by ``add_decayed_weights``, are plain
  elementwise PyTorch on the card, as the JAX package leaves them to XLA.

Each also reports its update vector's size to the engine's health
sentinels, the JAX engine's ``lr * ||u||``: a leaf-wise optimizer writes
``Σu²`` into the ``sq`` slots it is given (:meth:`sq_slots` of them; kernel
E writes one partial a block), LAMB each group's ``ratio * ||u||`` (K7's
ratio kernel).

The 1-bit optimizers raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.config import core as config_core
from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fused
from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as lamb

_NOT_PORTED = {
    config_core.ONEBIT_ADAM_OPTIMIZER: "queue 1: runtime/fp16/onebit/",
    config_core.ZERO_ONE_ADAM_OPTIMIZER: "queue 1: runtime/fp16/onebit/",
    config_core.ONEBIT_LAMB_OPTIMIZER: "queue 1: runtime/fp16/onebit/",
}


@dataclasses.dataclass
class AdamState:
    """The optimizer state: the update count and fp32 first / second
    moments per parameter leaf (the fields of optax's ``ScaleByAdamState``
    and the JAX package's ``FusedAdamState``)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    FIELDS = ("mu", "nu")


@dataclasses.dataclass
class SGDState:
    """optax ``TraceState``: the momentum buffer per leaf (fp32)."""
    count: int
    trace: Dict[str, torch.Tensor]
    FIELDS = ("trace",)


@dataclasses.dataclass
class LionState:
    """optax ``ScaleByLionState``: the update count and the fp32 momentum."""
    count: int
    mu: Dict[str, torch.Tensor]
    FIELDS = ("mu",)


@dataclasses.dataclass
class AdagradState:
    """optax ``ScaleByRssState``: the running sum of squared gradients."""
    count: int
    sum_of_squares: Dict[str, torch.Tensor]
    FIELDS = ("sum_of_squares",)


def _full(named_params, value: float = 0.0):
    return {n: torch.full(p.shape, value, dtype=torch.float32, device=p.device)
            for n, p in named_params.items()}


def _sum_sq_into(sq: Optional[torch.Tensor], u: torch.Tensor) -> None:
    """Write ``Σu²`` (fp32) into the one slot ``sq`` when asked."""
    if sq is not None:
        sq.copy_(torch.sum(torch.square(u)).reshape(1))


class _OneSlot:
    @staticmethod
    def sq_slots(n: int) -> int:
        """Slots of the ``sq`` buffer a leaf of ``n`` elements takes."""
        return 1


class Adam:
    """Adam / AdamW applied leaf by leaf through ``fused_adam_step`` (kernel
    E on CUDA tensors, its plain version on the CPU). ``adam_w_mode``
    decouples weight decay (``u + wd * p``); otherwise it is L2 folded into
    the gradient first."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)

    group_update = None           # one leaf at a time
    sq_slots = staticmethod(fused.adam_blocks)

    def init(self, named_params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu=_full(named_params), nu=_full(named_params))

    def leaf_update(self, state: AdamState, name: str, grad: torch.Tensor,
                    param: torch.Tensor, lr: float, sq: Optional[torch.Tensor] = None) -> None:
        """``param <- param - lr * u`` in place (``param`` contiguous; the
        master, or the fp32 param) for one leaf at update count
        ``state.count`` (1-based, already advanced by the caller); the
        leaf's moments are updated in place too, and ``sq`` (when given)
        gets the partial sums of ``u²``."""
        flat = param.view(-1)
        fused.fused_adam_step(flat, grad.reshape(-1), state.mu[name].view(-1),
                              state.nu[name].view(-1), step=state.count, lr=lr, b1=self.b1,
                              b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
                              adam_w_mode=self.adam_w_mode, emit="param", out=flat, sq=sq)


class Lamb:
    """LAMB over groups of leaves: Adam's unscaled update plus ``wd * p``,
    scaled by one trust ratio ``||p|| / ||u||`` per group (a JAX leaf),
    through ``lamb_moments`` / ``lamb_ratio`` / ``lamb_apply`` (the K7
    kernels on CUDA tensors, their plain versions on the CPU)."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, bias_correction: bool = True):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.bias_correction = bool(bias_correction)

    def init(self, named_params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu=_full(named_params), nu=_full(named_params))

    def group_update(self, state: AdamState, names: List[str],
                     grad: Callable[[str], torch.Tensor], params: Dict[str, torch.Tensor],
                     lr: float, unorm: Optional[torch.Tensor] = None,
                     reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                     device=None) -> torch.Tensor:
        """``param <- param - lr * ratio * u`` in place for the leaves
        ``names`` of one JAX leaf at update count ``state.count``; ``grad(n)``
        returns leaf n's unscaled, clipped gradient (called once each, in
        order, so only one is alive at a time). The ratio stays on the
        device and is returned; ``unorm`` (one fp32 value, when given) gets
        ``ratio * ||u||``. Under ZeRO ``names`` are this rank's segments of
        the JAX leaf (maybe none, on ``device``) and ``reduce`` sums the
        partials over the ranks before the ratio (:func:`lamb_group_step`)."""
        flat = lambda d: [d[n].view(-1) for n in names]
        return lamb.lamb_group_step(
            flat(params), lambda i: grad(names[i]).reshape(-1), flat(state.mu), flat(state.nu),
            step=state.count, lr=lr, b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, bias_correction=self.bias_correction, unorm=unorm,
            reduce=reduce, device=device)


class SGD(_OneSlot):
    """optax ``trace(decay=momentum, nesterov)`` then ``+ wd * p``."""
    group_update = None

    def __init__(self, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        self.weight_decay = float(weight_decay)

    def init(self, named_params: Dict[str, torch.Tensor]) -> SGDState:
        return SGDState(count=0, trace=_full(named_params))

    def leaf_update(self, state: SGDState, name: str, grad: torch.Tensor,
                    param: torch.Tensor, lr: float, sq: Optional[torch.Tensor] = None) -> None:
        g = grad.float()
        t = state.trace[name]
        t.copy_(g + self.momentum * t)
        u = g + self.momentum * t if self.nesterov else t
        if self.weight_decay:
            u = u + self.weight_decay * param
        _sum_sq_into(sq, u)
        param.sub_(lr * u)


class Lion(_OneSlot):
    """optax ``scale_by_lion(b1, b2)`` then ``+ wd * p``:
    ``u = sign((1 - b1) g + b1 m)``, then ``m <- (1 - b2) g + b2 m``."""
    group_update = None

    def __init__(self, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0):
        self.b1, self.b2 = float(b1), float(b2)
        self.weight_decay = float(weight_decay)

    def init(self, named_params: Dict[str, torch.Tensor]) -> LionState:
        return LionState(count=0, mu=_full(named_params))

    def leaf_update(self, state: LionState, name: str, grad: torch.Tensor,
                    param: torch.Tensor, lr: float, sq: Optional[torch.Tensor] = None) -> None:
        g = grad.float()
        m = state.mu[name]
        u = torch.sign((1.0 - self.b1) * g + self.b1 * m)
        m.copy_((1.0 - self.b2) * g + self.b2 * m)
        if self.weight_decay:
            u = u + self.weight_decay * param
        _sum_sq_into(sq, u)
        param.sub_(lr * u)


class Adagrad(_OneSlot):
    """optax ``scale_by_rss(initial_accumulator_value, eps)`` then
    ``+ wd * p``: ``s <- s + g^2``, ``u = where(s > 0, rsqrt(s + eps), 0) * g``."""
    group_update = None

    def __init__(self, initial_accumulator_value: float = 0.0, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        self.initial_accumulator_value = float(initial_accumulator_value)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, named_params: Dict[str, torch.Tensor]) -> AdagradState:
        return AdagradState(count=0, sum_of_squares=_full(named_params,
                                                          self.initial_accumulator_value))

    def leaf_update(self, state: AdagradState, name: str, grad: torch.Tensor,
                    param: torch.Tensor, lr: float, sq: Optional[torch.Tensor] = None) -> None:
        g = grad.float()
        s = state.sum_of_squares[name]
        s.add_(g * g)
        u = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s)) * g
        if self.weight_decay:
            u = u + self.weight_decay * param
        _sum_sq_into(sq, u)
        param.sub_(lr * u)


def jax_state_layout(name: Optional[str], params: Optional[Dict[str, Any]] = None):
    """Where the JAX engine's optimizer state keeps its leaves, for config
    ``optimizer.type`` ``name`` and ``optimizer.params``: ``(prefix,
    fields)``, the state node's path (``jax.tree_util.keystr``: ``""`` for
    the fused ``FusedAdamState`` / ``FusedLambState``, ``"[i]"`` for element
    i of an optax chain) and the fields it flattens, in order (``count`` is
    a 0-d int32 leaf; the others hold one leaf per parameter leaf, in the
    parameter tree's flatten order). The chain elements without leaves
    (``add_decayed_weights``, ``identity``, ``scale_by_trust_ratio``) hold
    no place in the flattened state."""
    params = dict(params or {})
    name = (name or config_core.ADAMW_OPTIMIZER).lower()
    if name in (config_core.FUSED_ADAM_OPTIMIZER, config_core.FUSED_LAMB_OPTIMIZER):
        return "", ("count", "mu", "nu")
    if name == config_core.ADAM_OPTIMIZER:
        # L2 decay runs first in the chain, ahead of scale_by_adam
        l2 = params.get("weight_decay", 0.0) and not params.get("adam_w_mode", False)
        return ("[1]" if l2 else "[0]"), ("count", "mu", "nu")
    if name in (config_core.ADAMW_OPTIMIZER, config_core.LAMB_OPTIMIZER):
        return "[0]", ("count", "mu", "nu")
    if name == config_core.SGD_OPTIMIZER:
        return "[0]", ("trace",)
    if name == config_core.LION_OPTIMIZER:
        return "[0]", ("count", "mu")
    if name == config_core.ADAGRAD_OPTIMIZER:
        return "[0]", ("sum_of_squares",)
    raise ValueError(f"no JAX state layout for optimizer {name}")


def optimizer_momenta(name: Optional[str], params: Optional[Dict[str, Any]]):
    """The momenta ``build_optimizer`` applies for this config (the JAX
    package's ``optimizer_momenta``): ``momentum`` for SGD, the betas tuple
    for the Adam family and Lion, None for a client optimizer."""
    if name is None or name == "client":
        return None
    params = params or {}
    lname = name.lower()
    if lname in ("sgd", "rmsprop"):
        return params.get("momentum", 0.0)
    if lname == "lion":
        return tuple(params.get("betas", (0.9, 0.99)))
    return tuple(params.get("betas", (0.9, 0.999)))


def _adam_args(params: Dict[str, Any]) -> Dict[str, Any]:
    betas = params.get("betas", (0.9, 0.999))
    return dict(b1=betas[0], b2=betas[1], eps=params.get("eps", 1e-8),
                weight_decay=params.get("weight_decay", 0.0))


def build_optimizer(name: Optional[str], params: Optional[Dict[str, Any]] = None):
    """The engine-built optimizer for config ``optimizer.type`` ``name``
    (default adamw) with ``optimizer.params`` (``lr`` is the engine's)."""
    params = dict(params or {})
    name = (name or config_core.ADAMW_OPTIMIZER).lower()
    wd = params.get("weight_decay", 0.0)
    if name == config_core.ADAM_OPTIMIZER:
        # reference Adam applies L2-style weight decay unless adam_w_mode
        return Adam(adam_w_mode=params.get("adam_w_mode", False), **_adam_args(params))
    if name == config_core.ADAMW_OPTIMIZER:
        return Adam(adam_w_mode=True, **_adam_args(params))
    if name == config_core.FUSED_ADAM_OPTIMIZER:
        return Adam(adam_w_mode=params.get("adam_w_mode", True), **_adam_args(params))
    if name in (config_core.FUSED_LAMB_OPTIMIZER, config_core.LAMB_OPTIMIZER):
        betas = params.get("betas", (0.9, 0.999))
        return Lamb(b1=betas[0], b2=betas[1], eps=params.get("eps", 1e-6), weight_decay=wd)
    if name == config_core.SGD_OPTIMIZER:
        return SGD(momentum=params.get("momentum", 0.0), nesterov=params.get("nesterov", False),
                   weight_decay=wd)
    if name == config_core.ADAGRAD_OPTIMIZER:
        return Adagrad(initial_accumulator_value=params.get("initial_accumulator_value", 0.0),
                       eps=params.get("eps", 1e-10), weight_decay=wd)
    if name == config_core.LION_OPTIMIZER:
        betas = params.get("betas", (0.9, 0.99))
        return Lion(b1=betas[0], b2=betas[1], weight_decay=wd)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name} is not ported to deepspeed_tpu_torch yet "
                                  f"(ROADMAP.md {_NOT_PORTED[name]})")
    raise ValueError(f"Unknown optimizer: {name}")
