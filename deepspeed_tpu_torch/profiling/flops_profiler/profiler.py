"""FLOPS profiler (counterpart of
``deepspeed_tpu/profiling/flops_profiler/profiler.py``; reference
``profiling/flops_profiler/profiler.py``).

The reference patches ``torch.nn.functional`` and Tensor methods to count
MACs as the model runs. The JAX package walks the traced computation
(``flops_from_jaxpr``) and prefers XLA's ``compiled.cost_analysis()``. The
port counts what the JAX walk counts, over the aten ops that one call of
the function runs (:class:`FlopCounter`, a ``TorchDispatchMode``), with the
walk's classes:

- products (``mm``, ``bmm``, ``addmm``, ``baddbmm``: the matmuls that
  ``matmul``, ``linear`` and ``einsum`` lower to) as ``dot_general``,
  2·batch·M·N·K;
- ``convolution`` as ``conv_general_dilated``, 2·output elements·(input
  channels / groups · kernel elements);
- the walk's elementwise primitives (add, sub, mul, div, max, min, exp,
  log, tanh, logistic, rsqrt, sqrt, neg, abs, pow, erf, sin, cos) by
  output elements; reductions (sum, mean, amax, amin, prod, any, all) by
  input elements.

A launch of one of the port's hand-written kernels counts 0, as the walk
counts a ``pallas_call``: kernel A's op ``dstpu::flash_fwd`` is not an aten
op (its inner work is not seen), and the ctypes launches are not
dispatcher ops at all. Torch has no counterpart of ``cost_analysis()``, so
the port's count is always the walk's; composite ops that the JAX walk
sees as several primitives (a softmax, a norm) and torch runs as one aten
op count differently in the two packages, products and convolutions
identically.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu_torch.utils.pytree import tree_leaves


# ------------------------------------------------------------------ #
# pretty printing (reference number_to_string/macs_to_string family)

def number_to_string(num: float, units: Optional[str] = None, precision: int = 2) -> str:
    if units is None:
        for cutoff, u in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
            if abs(num) >= cutoff:
                return f"{num / cutoff:.{precision}f} {u}"
        return f"{num:.{precision}f}"
    scale = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "": 1.0}[units]
    return f"{num / scale:.{precision}f} {units}"


# ------------------------------------------------------------------ #
# the aten count

# aten op -> the JAX walk's primitive name
_ELEMENTWISE = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min", "exp": "exp", "log": "log", "tanh": "tanh",
    "sigmoid": "logistic", "rsqrt": "rsqrt", "sqrt": "sqrt", "neg": "neg", "abs": "abs",
    "pow": "pow", "erf": "erf", "sin": "sin", "cos": "cos",
}
_REDUCTIONS = {
    "sum": "reduce_sum", "mean": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    "max": "reduce_max", "min": "reduce_min", "prod": "reduce_prod", "any": "reduce_or",
    "all": "reduce_and",
}
_PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 1


def _product_flops(name: str, args) -> float:
    a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1], args[2])
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    return 2.0 * batch * m * n * k


def _conv_flops(args, out) -> float:
    weight = args[1]
    transposed = bool(args[6]) if len(args) > 6 else False
    groups = int(args[8]) if len(args) > 8 else 1
    # flops per output element: the input channels of its group times the
    # kernel's spatial size (weight [O, I/g, k...] or transposed [I, O/g, k...])
    per_output = (weight.shape[0] // groups if transposed else weight.shape[1]) \
        * math.prod(weight.shape[2:])
    return 2.0 * out.numel() * per_output


def op_flops(func, args, kwargs, out) -> Dict[str, float]:
    """The walk's count of one aten op, by primitive name (empty: counts 0)."""
    if func.namespace != "aten":
        return {}
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _PRODUCTS:
        got = {"dot_general": _product_flops(name, args)}
        if name in ("addmm", "baddbmm"):       # the product, then the add of its input
            got["add"] = float(_numel(out))
        return got
    if name == "convolution":
        got = {"conv_general_dilated": _conv_flops(args, out)}
        if args[2] is not None:                # a bias, added after the product
            got["add"] = float(out.numel())
        return got
    if name in ("max", "min") and len(args) > 1 and isinstance(args[1], torch.Tensor):
        return {_ELEMENTWISE["maximum" if name == "max" else "minimum"]: float(out.numel())}
    if name in _ELEMENTWISE:
        res = out[0] if isinstance(out, (tuple, list)) else out
        return {_ELEMENTWISE[name]: float(_numel(res))}
    if name in _REDUCTIONS:
        return {_REDUCTIONS[name]: float(_numel(args[0]))}
    return {}


class FlopCounter(TorchDispatchMode):
    """Counts the flops of the aten ops run inside the ``with`` body, by the
    JAX walk's primitive names (``breakdown``) and in all (``total``)."""

    def __init__(self):
        super().__init__()
        self.breakdown: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for k, v in op_flops(func, args, kwargs or {}, out).items():
            self.breakdown[k] = self.breakdown.get(k, 0.0) + v
        return out

    @property
    def total(self) -> float:
        return float(sum(self.breakdown.values()))


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[float, Dict[str, float]]:
    """``(total, breakdown)`` of one call of ``fn`` (no autograd graph is
    built: the count is the forward's)."""
    with torch.no_grad(), FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total, dict(counter.breakdown)


# ------------------------------------------------------------------ #

def _count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def get_model_profile(model=None, fn: Optional[Callable] = None, args: Tuple = (),
                      kwargs: Optional[Dict] = None, print_profile: bool = True,
                      detailed: bool = True, as_string: bool = True):
    """Standalone profile (reference ``get_model_profile``): returns
    (flops, macs, params) for one forward call.

    Either ``model`` (an object with ``.forward(params, ...)``; args[0] must
    be the parameter tree) or a bare ``fn``.
    """
    kwargs = kwargs or {}
    target = fn if fn is not None else (lambda *a, **k: model.forward(*a, **k))
    flops, breakdown = count_flops(target, *args, **kwargs)
    macs = flops / 2.0
    # contract: args[0] is the parameter tree (both model and bare-fn paths)
    params = _count_params(args[0]) if args else 0

    if print_profile:
        print("-" * 60)
        print("deepspeed_tpu_torch flops profile")
        print(f"params:           {number_to_string(params)}")
        print(f"fwd flops:        {number_to_string(flops)}")
        print(f"fwd MACs:         {number_to_string(macs)}MACs")
        if detailed and breakdown:
            print("per-primitive breakdown (aten ops, by the JAX walk's names):")
            for prim, f in sorted(breakdown.items(), key=lambda kv: -kv[1])[:10]:
                print(f"  {prim:<24} {number_to_string(f)}")
        print("-" * 60)

    if as_string:
        return number_to_string(flops), f"{number_to_string(macs)}MACs", number_to_string(params)
    return flops, macs, params


class FlopsProfiler:
    """Engine-integrated profiler (reference ``FlopsProfiler``): profiles the
    training loss at the configured step."""

    def __init__(self, model=None, ds_engine=None, recompute_fwd_factor: float = 0.0):
        self.model = model
        self.ds_engine = ds_engine
        self.recompute_fwd_factor = recompute_fwd_factor
        self.started = False
        self.flops = 0.0
        self.macs = 0.0
        self.params = 0
        self.breakdown: Dict[str, float] = {}

    def start_profile(self, ignore_list=None) -> None:
        self.started = True
        self.flops = 0.0

    def profile_fn(self, fn: Callable, *args, **kwargs) -> None:
        self.flops, self.breakdown = count_flops(fn, *args, **kwargs)
        self.macs = self.flops / 2.0
        if args:
            self.params = _count_params(args[0])

    def get_total_flops(self, as_string: bool = False):
        total = self.flops * (1.0 + self.recompute_fwd_factor)
        return number_to_string(total) if as_string else total

    def get_total_macs(self, as_string: bool = False):
        return number_to_string(self.macs) if as_string else self.macs

    def get_total_params(self, as_string: bool = False):
        return number_to_string(self.params) if as_string else self.params

    def print_model_profile(self, profile_step: int = 1, module_depth: int = -1,
                            top_modules: int = 1, detailed: bool = True,
                            output_file: Optional[str] = None) -> None:
        lines = [
            "-" * 60,
            f"flops profile at step {profile_step}",
            f"params:       {self.get_total_params(as_string=True)}",
            f"fwd flops:    {self.get_total_flops(as_string=True)}",
            f"fwd MACs:     {self.get_total_macs(as_string=True)}MACs",
            "-" * 60,
        ]
        text = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(text + "\n")
        else:
            print(text)

    def stop_profile(self) -> None:
        self.started = False

    def end_profile(self) -> None:
        self.stop_profile()

