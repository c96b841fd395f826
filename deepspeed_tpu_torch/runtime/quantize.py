"""Training-time progressive quantization (MoQ), the counterpart of
``deepspeed_tpu/runtime/quantize.py``.

The :class:`Quantizer` walks a per-leaf bit-width schedule from
``start_bits`` to ``target_bits``, doubling the period at each drop, and
fake-quantizes the live compute-dtype params after each ``train_batch``:
symmetric or asymmetric, nearest or stochastic rounding (the symmetric
stochastic form runs kernel ``sr_quantize.cu`` on the card), ternary and
binary at 2 and 1 bits, and optional mixed-fp16 blending that anneals from
the unquantized value to the quantized one.

It works per **JAX leaf**, as the JAX package does: the per-layer port
leaves ``layers.{i}.<path>`` form one stacked leaf ``['layers'][...]`` whose
schedule state is keyed by the same ``keystr`` string, whose rank is taken
on the stacked shape (so the stacked norm scales ``[L, D]`` are quantized),
whose ``q_groups`` groups run over the flattened stacked leaf (a group may
span layers), and whose rounding seed is ``qsteps + 7919 * leaf_idx`` over
the JAX flattened order (:func:`~deepspeed_tpu_torch.runtime.utils.jax_leaves`).
With ``q_eigenvalue`` the schedule is eigenvalue-guided as in the JAX
package: ``quantize_tree(..., block_eigenvalue={segment: value})`` stretches
the period of every JAX leaf whose path holds that exact segment by ``1 +
floor(value * 4)`` at its next bit drop (curvier blocks quantize later;
the engine computes the values, ``runtime/eigenvalue.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.ops.quantizer import kernels as qk
from deepspeed_tpu_torch.runtime.utils import jax_leaves, keystr
from deepspeed_tpu_torch.utils.logging import logger

TWO_D_PARAMS = 6
SEED_STRIDE = 7919          # leaf_idx multiplier of the rounding seed


def _quantize_ternary(x, groups: int):
    flat = x.float().reshape(groups, -1)
    n = flat.shape[1]
    m = flat.abs().sum(dim=1, keepdim=True) / n
    thres = 0.7 * m
    mask = flat.abs() > thres
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    alpha = (flat.abs() * mask).sum(dim=1, keepdim=True) / denom
    zero = torch.zeros_like(flat)
    out = torch.where(flat > thres, alpha, torch.where(flat < -thres, -alpha, zero))
    return out.reshape(x.shape).to(x.dtype)


def _quantize_binary(x, groups: int):
    flat = x.float().reshape(groups, -1)
    m = flat.abs().sum(dim=1, keepdim=True) / flat.shape[1]
    return (torch.sign(flat) * m).reshape(x.shape).to(x.dtype)


class Quantizer:
    """The JAX ``Quantizer``'s constructor surface and schedule over the
    port's per-layer leaves."""

    def __init__(self, q_groups: int = 1, q_mixed_fp16: bool = False,
                 q_change_ratio: float = 0.01, q_type: str = "symmetric",
                 q_rounding: str = "nearest", q_verbose: bool = False,
                 q_eigenvalue: bool = False, start_bits: int = 16,
                 target_bits: int = 8, q_period: int = 100):
        self.q_groups = q_groups
        self.q_mixed_fp16 = q_mixed_fp16
        self.q_change_ratio = q_change_ratio
        self.q_type = q_type
        self.q_rounding = q_rounding
        self.q_verbose = q_verbose
        self.q_eigenvalue = q_eigenvalue
        self.qsteps = 0
        self.quantize_real_ratio = 1.0
        self.start_bits = start_bits
        self.target_bits = target_bits
        self.default_period = q_period
        # per-leaf schedule state: keystr -> {"bits": int, "period": int}
        self._state: Dict[Any, Dict[str, int]] = {}

    # -------------------- checkpoint -------------------- #

    def state_dict(self):
        return {"qsteps": self.qsteps,
                "quantize_real_ratio": self.quantize_real_ratio,
                "leaf_state": {k: dict(v) for k, v in self._state.items()}}

    def load_state_dict(self, sd):
        self.qsteps = int(sd["qsteps"])
        self.quantize_real_ratio = float(sd["quantize_real_ratio"])
        self._state = {k: dict(v) for k, v in sd["leaf_state"].items()}

    # -------------------- schedule -------------------- #

    def step(self):
        self.qsteps += 1

    def update_fp16_ratio(self):
        if self.q_mixed_fp16:
            self.quantize_real_ratio = max(0.0, self.quantize_real_ratio - self.q_change_ratio)

    def _leaf_state(self, key):
        if key not in self._state:
            self._state[key] = {"bits": self.start_bits, "period": self.default_period}
        return self._state[key]

    def any_precision_switch(self) -> bool:
        if not self._state:
            return True
        n = max(len(self._state), 1)
        return any(st["bits"] != self.target_bits and
                   self.qsteps + TWO_D_PARAMS * n >= st["period"]
                   for st in self._state.values())

    # -------------------- quantization -------------------- #

    def _compute_one(self, key: str, leaves: List[torch.Tensor], leaf_idx: int,
                     eigenvalue: Optional[float] = None) -> None:
        """Quantize the port leaves of one JAX leaf in place."""
        st = self._leaf_state(key)
        if st["bits"] != self.target_bits and self.qsteps >= st["period"]:
            factor = 1 + math.floor(eigenvalue * 4) if eigenvalue is not None else 1
            self.quantize_real_ratio = 1.0
            st["period"] = (st["period"] << 1) * factor
            st["bits"] -= 1
            if self.q_verbose:
                logger.info(f"quantize {key}: bits={st['bits']} "
                            f"step={self.qsteps} period={st['period']}")
        if st["bits"] < self.target_bits:
            raise ValueError("Quantization bit is lower than target precision bits!")

        bits, groups = st["bits"], self.q_groups
        sym = self.q_type == "symmetric"
        mixed = self.q_mixed_fp16 and bits >= self.target_bits - 1
        # the symmetric stochastic kernel writes in place unless the mixed
        # blend still needs the unquantized values
        out = None if mixed else leaves
        if bits >= 3:
            seed = self.qsteps + SEED_STRIDE * leaf_idx
            if self.q_rounding != "nearest" and sym:
                q = qk.ds_sr_quantize_span(leaves, groups, bits, seed, out=out)
            elif self.q_rounding != "nearest":
                q = qk.ds_quantize_span(qk.ds_sr_quantize_asym, leaves, groups, bits, seed,
                                        out=out)
            else:
                fn = qk.ds_quantize if sym else qk.ds_quantize_asym
                q = qk.ds_quantize_span(fn, leaves, groups, bits, out=out)
        else:
            if not sym or self.q_rounding != "nearest":
                raise ValueError(("ternary" if bits == 2 else "binary") +
                                 " quantization requires symmetric/nearest")
            fn = _quantize_ternary if bits == 2 else _quantize_binary
            q = qk.ds_quantize_span(fn, leaves, groups, out=out)
        if mixed:
            r = self.quantize_real_ratio
            for x, qx in zip(leaves, q):
                x.copy_(r * x + (1 - r) * qx)

    @torch.no_grad()
    def quantize_tree(self, named_params: Dict[str, torch.Tensor], overflow: bool = False,
                      block_eigenvalue: Optional[Dict[str, float]] = None):
        """Quantize every JAX leaf of stacked rank >= 2 per its schedule, in
        place; ``named_params`` maps the port's leaf names to its tensors.
        ``block_eigenvalue`` maps an exact path SEGMENT of the JAX leaf (e.g.
        ``"layers"``) to its normalized eigenvalue, so ``"layer1"`` cannot
        match ``"layer10"``. With ``q_eigenvalue`` an overflow step still
        quantizes, as in the JAX package."""
        if overflow and not self.q_eigenvalue:
            return
        self.step()
        self.update_fp16_ratio()
        for idx, (path, names) in enumerate(jax_leaves(named_params).items()):
            leaves = [named_params[n] for n in names]
            rank = leaves[0].dim() + (1 if path[0] == "layers" and len(path) > 1 else 0)
            if rank < 2:
                continue
            ev = None
            if block_eigenvalue:
                for segment, val in block_eigenvalue.items():
                    if segment in path:
                        ev = val
                        break
            self._compute_one(keystr(path), leaves, idx, ev)


def quantizer_from_config(qt: Dict[str, Any]) -> Optional[Quantizer]:
    """The Quantizer of a ``quantize_training`` config section, with the JAX
    engine's key lookups (only keys present override the defaults)."""
    bits = qt.get("quantize_bits", {})
    sched = qt.get("quantize_schedule", {})
    algo = qt.get("quantize_algo", {})
    mixed = qt.get("fp16_mixed_quantize", {})
    kw = {k: v for k, v in dict(
        q_groups=qt.get("quantize_groups"),
        q_mixed_fp16=mixed.get("enabled"),
        q_change_ratio=mixed.get("quantize_change_ratio"),
        q_type=algo.get("q_type"),
        q_rounding=algo.get("q_rounding"),
        q_verbose=qt.get("quantize_verbose"),
        q_eigenvalue=qt.get("eigenvalue", {}).get("enabled"),
        start_bits=bits.get("start_bits"),
        target_bits=bits.get("target_bits"),
        q_period=sched.get("quantize_period"),
    ).items() if v is not None}
    return Quantizer(**kw)

