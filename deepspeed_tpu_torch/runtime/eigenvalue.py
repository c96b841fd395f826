"""Per-block Hessian max-eigenvalue estimation by power iteration, the
counterpart of ``deepspeed_tpu/runtime/eigenvalue.py``.

Reference parity: ``deepspeed/runtime/eigenvalue.py:13`` (``Eigenvalue`` —
power iteration with Hessian-vector products per transformer block, used by
the training-time quantizer to schedule per-layer precision: blocks with
larger curvature quantize later, ``runtime/quantize.py``).

The JAX package forms the Hessian-vector product forward over reverse
(``jvp(grad(loss))``); the port forms it reverse over reverse, a double
backward: ``g = autograd.grad(loss, leaves, create_graph=True)``, then the
gradient of ``<g, v>``. The iteration itself is the JAX one: the same loop,
stop rule, projection onto the block, normalisation and ``scale``. A block
is a set of the port's leaves (block i of :meth:`Eigenvalue.layer_masks` is
layer i's leaves, the JAX mask's index i of every stacked leaf), and the HVP
is taken with respect to the block's leaves only: the projection zeroes
every other entry of ``H v`` anyway, so the result is the masked one.

The HVP runs on **plain attention and the plain CE head**. The attention
kernels A, C and D and the fused CE kernels are not twice differentiable in
either package (the JAX package's jvp of grad cannot pass the Pallas
kernels' ``custom_vjp``, and raises there), so the function the JAX package
computes is the HVP through its ``"xla"`` attention. :func:`hvp_model` is
the one place that sets this: it returns the model with
``attention_backend="xla"`` and ``fused_cross_entropy="off"``, and the
engine's HVP closure runs that model, so no attention or CE kernel launches
inside an HVP. Its start vectors are fp32, as the JAX package's are; the
JAX engine's jvp refuses compute params of another dtype (TypeError), and
so does this one.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from deepspeed_tpu_torch.utils.logging import log_dist

_PLAIN = {"attention_backend": "xla", "fused_cross_entropy": "off"}


def _nan_to_num(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _inner(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def _plain_config_model(model):
    cfg = getattr(model, "config", None)
    if not (dataclasses.is_dataclass(cfg) and all(hasattr(cfg, k) for k in _PLAIN)):
        raise ValueError(f"the eigenvalue HVP needs a model whose config has "
                         f"{sorted(_PLAIN)} (got {type(model).__name__})")
    twin = copy.copy(model)
    zoo = getattr(model, "zoo_cfg", None)
    twin.config = dataclasses.replace(cfg, **_PLAIN)
    if zoo is not None:
        # a derived config (BertModel.zoo_cfg) keeps its overrides (a sparsity layout)
        twin.zoo_cfg = dataclasses.replace(zoo, **_PLAIN)
    return twin


def hvp_model(model):
    """``model`` with plain attention and the plain CE head: the function
    the HVP differentiates twice (see the module docstring). A
    ``CompressedModel`` keeps its rules and active set, its variants
    switched to plain attention; a bare loss callable is returned as it is."""
    if hasattr(model, "_plain_model"):          # a CompressedModel
        twin = copy.copy(model)
        acting = model.model is getattr(model, "_act_model", None)
        twin._plain_model = _plain_config_model(model._plain_model)
        if getattr(model, "_act_model", None) is not None:
            twin._act_model = _plain_config_model(model._act_model)
        twin.model = twin._act_model if acting else twin._plain_model
        return twin
    if getattr(model, "config", None) is None and callable(model):
        return model
    return _plain_config_model(model)


class Eigenvalue:
    """The JAX ``Eigenvalue``'s config surface (max_iter / tol / stability /
    gas_boundary_resolution); ``layer_name`` / ``layer_num`` become an
    explicit list of blocks (:meth:`layer_masks`)."""

    def __init__(self, verbose: bool = False, max_iter: int = 100,
                 tol: float = 1e-2, stability: float = 1e-6,
                 gas_boundary_resolution: int = 1):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.iterations: List[int] = []     # of the last compute_eigenvalue, per block

    # -------------------- core math -------------------- #

    def _hvp_fn(self, loss_fn: Callable, leaves: Sequence[torch.Tensor]):
        """``hvp(params, v)``: H v over ``leaves`` (tensors of ``params``
        that require grad), ``loss_fn(params)`` a scalar."""
        def hvp(params, v):
            with torch.enable_grad():
                loss = loss_fn(params)
                g = torch.autograd.grad(loss, leaves, create_graph=True, allow_unused=True)
                gv = sum((gi * vi.to(gi.dtype)).sum() for gi, vi in zip(g, v)
                         if gi is not None)
                if not torch.is_tensor(gv) or not gv.requires_grad:
                    return [torch.zeros_like(x) for x in v]
                hv = torch.autograd.grad(gv, leaves, allow_unused=True)
            return [torch.zeros_like(x) if h is None else h.to(x.dtype) for h, x in zip(hv, v)]
        return hvp

    def _power_iterate(self, hvp, params, v, mask, scale, history: Optional[list] = None):
        """Power iteration restricted to the masked subspace; ``v`` and
        ``mask`` are lists over the leaves ``hvp`` differentiates. Each
        iteration's eigenvalue (times ``scale``) is appended to ``history``
        when one is given."""
        def project(t):
            return [_nan_to_num(x) * m for x, m in zip(t, mask)]

        def normalize(t):
            norm = torch.sqrt(_inner(t, t)) + self.stability
            return [_nan_to_num(x / norm) for x in t]

        v = normalize(project(v))
        eig_prev, eig = 0.0, 1.0
        it = 0
        while it < self.max_iter and abs(eig) > 0 and \
                abs((eig - eig_prev) / eig) >= self.tol:
            eig_prev = eig
            hv = project(hvp(params, v))
            eig = float(_inner(hv, v))
            v = [x / scale for x in normalize(hv)]
            it += 1
            if history is not None:
                history.append(eig * scale)
        return eig * scale, it

    # -------------------- public API -------------------- #

    def compute_eigenvalue(self, loss_fn: Callable, params: Any,
                           blocks: Sequence[Dict[str, float]],
                           generator: Optional[torch.Generator] = None,
                           scale: float = 1.0) -> List[float]:
        """Max |eigenvalue| of the loss Hessian restricted to each block.

        ``loss_fn(params) -> scalar``; ``params`` a ParamTree whose tensors
        require grad; ``blocks`` a list of {leaf name:
        0/1} masks. Each block's fp32 start vector is drawn for every leaf
        from ``generator`` (default: seeded 0 on the params' device), in
        leaf order. Returns the reference's post-processed values: ``|λ|``
        mapped to [0, 1] by the max across blocks, invalid blocks -> 1.0.
        """
        named = dict(params.named_parameters())
        for n, t in named.items():
            if t.dtype != torch.float32:
                # the JAX engine's jvp: fp32 tangents for these primals
                raise TypeError(
                    "primal and tangent arguments to the HVP do not match; dtypes must be "
                    f"equal. Got primal dtype {t.dtype} ({n}) and so expected tangent dtype "
                    f"{t.dtype}, but got tangent dtype torch.float32 instead (the JAX "
                    "package's jvp raises here too: the eigenvalue schedule runs on fp32 "
                    "params)")
        device = next(iter(named.values())).device
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        raw, self.iterations = [], []
        for i, mask in enumerate(blocks):
            v0 = {n: torch.randn(t.shape, generator=gen, dtype=torch.float32, device=device)
                  for n, t in named.items()}
            sel = [n for n in named if mask.get(n, 0.0) != 0.0]
            if sel:
                hvp = self._hvp_fn(loss_fn, [named[n] for n in sel])
                eig, iters = self._power_iterate(hvp, params, [v0[n] for n in sel],
                                                 [mask[n] for n in sel], scale)
            else:       # the JAX iteration on an empty block: one HVP of 0, eig 0
                eig, iters = 0.0, 1
            del v0
            raw.append(eig)
            self.iterations.append(iters)
            if self.verbose:
                log_dist(f"block {i}: power iterations {iters}, "
                         f"eigenvalue {eig}", ranks=[0])
        return self.post_process(raw)

    def layer_masks(self, params: Any, stacked_path: str, n_layer: int) -> List[Dict[str, float]]:
        """Block i selects layer i's leaves (``{stacked_path}.{i}.*``), the
        JAX mask's index i of every stacked leaf under
        ``params[stacked_path]`` (the analogue of the reference's
        ``layer_name`` / ``layer_num``); a block past the last layer selects
        nothing, as the JAX mask's out-of-bounds index does."""
        names = [n for n, _ in params.named_parameters()]
        return [{n: 1.0 if n.startswith(f"{stacked_path}.{i}.") else 0.0 for n in names}
                for i in range(n_layer)]

    def post_process(self, values: List[float]) -> List[float]:
        """Reference semantics: |λ| / max|λ|; zero (failed) blocks -> 1.0."""
        if not values:
            return values
        mx = abs(max(values, key=abs))
        if mx == 0.0:
            return [1.0] * len(values)
        return [abs(v) / mx if v != 0.0 else 1.0 for v in values]
