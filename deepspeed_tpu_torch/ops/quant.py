"""Weight-only int8 quantization for inference: the port of
``deepspeed_tpu/ops/quant.py``.

A :class:`Quantized8` holds an int8 payload ``q`` of the weight's shape and
fp32 per-group scales ``[..., groups]`` over the LAST axis (the port's
matmul weights are ``[in, out]``, so a group is a run of output columns of
one input row), and ``w ~= q * scale``. The card holds the int8 payload at
rest; each matmul site reads its weight through :func:`maybe_dequant`,
which turns one matrix at a time into the activations' dtype (the
``csrc/dequant_int8.cu`` kernel on the card, its plain version on the
CPU), so the 16-bit copy of a weight lives only for its product. Where the
JAX package scans over stacked ``[L, in, out]`` leaves, the port keeps one
``Quantized8`` per layer; grouping is per row over the last axis, so a
layer's slice of the stacked payload and scales is exactly what
quantizing that layer alone gives (``checkpoint/from_jax.py`` carries
them across).

``align_quant_groups`` and ``quantized_shardings`` of the JAX module
belong to tensor-parallel serving and wait for it (ROADMAP.md queue 1,
sharded serving).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from deepspeed_tpu_torch.ops.kernels.dequant_int8 import dequant_int8


class Quantized8(nn.Module):
    """Symmetric per-group int8 weight: ``w ~= q * scale`` (scale broadcast
    over the quantization axis, always the last one). ``q`` and ``scale``
    are frozen parameters, so a ``ParamTree`` holding one lists them as
    ``<key>.q`` and ``<key>.scale``."""

    def __init__(self, q, scale):
        super().__init__()
        q, scale = torch.as_tensor(q), torch.as_tensor(scale)
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"Quantized8 holds int8 q and fp32 scales, got {q.dtype} and "
                            f"{scale.dtype}")
        if tuple(scale.shape[:-1]) != tuple(q.shape[:-1]) or q.shape[-1] % scale.shape[-1]:
            raise ValueError(f"scale {tuple(scale.shape)} does not group q {tuple(q.shape)}")
        self.q = nn.Parameter(q, requires_grad=False)
        self.scale = nn.Parameter(scale, requires_grad=False)

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The weight in ``dtype``: one fp32 product an element, rounded once."""
        return dequant_int8(self.q, self.scale, dtype)

    def to_device(self, device) -> "Quantized8":
        """A copy on ``device`` (payload int8, scales fp32, as they are)."""
        return Quantized8(self.q.data.to(device), self.scale.data.to(device))

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4

    def extra_repr(self) -> str:
        return f"shape={tuple(self.q.shape)}, groups={self.scale.shape[-1]}"


def quantize_int8(w, groups: int = 1) -> Quantized8:
    """Symmetric per-(row x group) int8 quantization over the last axis, in
    fp32: scale = amax / 127 (1 for an all-zero group), q = round(w / scale)
    clipped to [-127, 127], on ``w``'s device."""
    w = torch.as_tensor(w)
    *lead, last = w.shape
    if last % groups:
        raise ValueError(f"last dim {last} not divisible by q_groups {groups}")
    wg = w.float().reshape(*lead, groups, last // groups)
    amax = wg.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wg / scale[..., None]), -127, 127).to(torch.int8)
    return Quantized8(q.reshape(*lead, last), scale)


def maybe_dequant(w: Any, dtype=torch.bfloat16):
    """Transparent weight access for the model's matmul sites."""
    if isinstance(w, Quantized8):
        return w.dequant(dtype)
    return w


# res_* are the PR-MoE dense-branch projections (the JAX list, kept whole);
# the tiny gate / coef matrices stay dense
_QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "res_w_up", "res_w_down")


def _tree_of(params):
    """``(nested dict, rebuild)`` of a ParamTree or a nested dict."""
    from deepspeed_tpu_torch.models.transformer import ParamTree
    if isinstance(params, ParamTree):
        return params.to_dict(), ParamTree
    return params, lambda t: t


def quantize_leaves(params, groups_of, include_head: bool, head_groups: int):
    """``params`` with each quantizable matrix under ``layers`` replaced by
    ``quantize_int8(w, groups_of(key))`` (and ``lm_head`` by
    ``quantize_int8(w, head_groups)`` with ``include_head``); embeddings,
    norms and biases stay as they are. A ParamTree in, a ParamTree out."""
    tree, rebuild = _tree_of(params)

    def walk(node, under_layers):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if under_layers and k in _QUANTIZABLE and isinstance(v, torch.Tensor):
                    out[k] = quantize_int8(v, groups_of(k))
                else:
                    out[k] = walk(v, under_layers or k == "layers")
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v, under_layers) for v in node]
        return node

    out = walk(tree, False)
    if include_head and isinstance(out, dict) and isinstance(out.get("lm_head"), torch.Tensor):
        out["lm_head"] = quantize_int8(out["lm_head"], head_groups)
    return rebuild(out)


def quantize_params(params, groups: int = 1, include_embed: bool = False):
    """Quantize the transformer weight matrices of a param tree (attention
    and MLP projections, one group count for all; embeddings, norms and
    biases stay dense; the untied ``lm_head`` too with ``include_embed``)."""
    return quantize_leaves(params, lambda _: groups, include_embed, groups)


def tree_nbytes(params) -> int:
    """Bytes of every leaf of a param tree (a Quantized8 counts its payload
    and its scales)."""
    tree, _ = _tree_of(params)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, Quantized8):
        return tree.nbytes
    return tree.numel() * tree.element_size()
