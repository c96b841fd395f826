"""The expert bank: an expert-stacked feed-forward network (counterpart of
``deepspeed_tpu/moe/experts.py``; reference ``deepspeed/moe/experts.py``).

One parameter set with a leading ``num_experts`` dim, applied to every
expert's ``[C, D]`` slot block at once by batched matmul (``torch.bmm``),
where the JAX package vmaps one expert over the stacked leaves."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.quant import maybe_dequant


def expert_ffn(p, x, activation: str = "gelu"):
    """Every expert at once: ``x [E, C, D]`` through ``p``'s stacked
    ``w_up [E, D, F]``, ``b_up [E, F]``, ``w_down [E, F, D]``, ``b_down [E,
    D]`` -> ``[E, C, D]`` (tanh GeLU, or ReLU). An int8 ``Quantized8``
    weight (weight-only inference quantization) is dequantized to the
    input's dtype first."""
    h = torch.bmm(x, maybe_dequant(p["w_up"], x.dtype)) + p["b_up"][:, None, :]
    h = F.gelu(h, approximate="tanh") if activation == "gelu" else F.relu(h)
    return torch.bmm(h, maybe_dequant(p["w_down"], h.dtype)) + p["b_down"][:, None, :]


class ExpertFFN:
    """num_experts x (Linear -> activation -> Linear)."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int, activation: str = "gelu"):
        self.num_experts = num_experts
        self.d_model = d_model
        self.d_ff = d_ff
        self.activation = activation

    def init(self, generator: Optional[torch.Generator] = None, device="cpu",
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """The JAX package's init scales: N(0, 1/D) up, N(0, 1/F) down, zero biases."""
        E, D, Fd = self.num_experts, self.d_model, self.d_ff
        up = torch.randn((E, D, Fd), generator=generator, device=device) / math.sqrt(D)
        down = torch.randn((E, Fd, D), generator=generator, device=device) / math.sqrt(Fd)
        return {"w_up": up.to(dtype), "b_up": torch.zeros((E, Fd), device=device, dtype=dtype),
                "w_down": down.to(dtype), "b_down": torch.zeros((E, D), device=device, dtype=dtype)}

    def apply(self, p, x):
        """Every expert: ``x [E, C, D]`` -> ``[E, C, D]``."""
        return expert_ffn(p, x, self.activation)

    def apply_one(self, p, x):
        """One expert: ``p``'s leaves without the leading E dim, ``x [C, D]``."""
        return expert_ffn({k: v[None] for k, v in p.items()}, x[None], self.activation)[0]
