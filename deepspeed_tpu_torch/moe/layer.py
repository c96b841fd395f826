"""The user-facing MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``;
reference ``deepspeed/moe/layer.py``): gate + experts, and optionally the
residual (PR-)MoE blend with a dense MLP through a learned 2-way softmax
coefficient (DeepSpeed-MoE, arXiv:2201.05596). Expert parallelism beyond 1
is not ported (ROADMAP.md queue 1, "MoE with ep > 1")."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.moe.experts import ExpertFFN
from deepspeed_tpu_torch.moe.sharded_moe import MOELayer, TopKGate
from deepspeed_tpu_torch.ops.quant import maybe_dequant
from deepspeed_tpu_torch.utils.init_on_device import honors_on_device
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.not_ported import not_ported


def residual_blend(x, moe_out, mlp, coef_w, coef_b):
    """The PR-MoE blend (reference ``moe/layer.py`` :115-123): the dense MLP
    ``mlp`` (``w_up [D, F]``, ``b_up``, ``w_down [F, D]``, ``b_down``; an
    int8 weight dequantized to ``x``'s dtype) on ``x``, mixed with
    ``moe_out`` by a 2-way softmax coefficient over [moe, dense]."""
    h = F.gelu(x @ maybe_dequant(mlp["w_up"], x.dtype) + mlp["b_up"], approximate="tanh")
    res = h @ maybe_dequant(mlp["w_down"], h.dtype) + mlp["b_down"]
    coef = torch.softmax(x @ coef_w + coef_b, dim=-1)
    return moe_out * coef[..., 0:1] + res * coef[..., 1:2]


class MoE:
    """Mixture-of-experts block: ``out, l_aux, exp_counts = moe(params, x)``.
    Arguments as the JAX class's (reference ``MoE.__init__``), without the
    mesh."""

    def __init__(self, hidden_size: int, expert: Optional[ExpertFFN] = None,
                 num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, d_ff: Optional[int] = None):
        if num_experts % max(ep_size, 1) != 0:
            raise ValueError(f"num_experts {num_experts} must be divisible by ep_size {ep_size}")
        if ep_size > 1:
            not_ported(f"MoE with ep_size={ep_size}", "queue 1: MoE with ep > 1")
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.num_local_experts = num_experts // max(ep_size, 1)
        self.use_residual = use_residual
        self.expert = expert or ExpertFFN(num_experts, hidden_size, d_ff or 4 * hidden_size)
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor, eval_capacity_factor,
                             min_capacity, noisy_gate_policy, drop_tokens, use_rts)
        self.moe_layer = MOELayer(self.gate, self.expert.apply, self.num_local_experts)
        log_dist(f"MoE: {num_experts} experts, k={k}, capacity_factor={capacity_factor}, "
                 f"residual={use_residual}", ranks=[0])

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=torch.float32) -> Dict[str, Any]:
        params: Dict[str, Any] = {"gate": self.gate.init(generator, device, dtype),
                                  "experts": self.expert.init(generator, device, dtype)}
        if self.use_residual:
            D, Fd = self.hidden_size, self.expert.d_ff
            draw = lambda shape, s: (torch.randn(shape, generator=generator, device=device)
                                     * s).to(dtype)
            zeros = lambda n: torch.zeros((n,), device=device, dtype=dtype)
            params["residual_mlp"] = {"w_up": draw((D, Fd), 1.0 / math.sqrt(D)),
                                      "b_up": zeros(Fd),
                                      "w_down": draw((Fd, D), 1.0 / math.sqrt(Fd)),
                                      "b_down": zeros(D)}
            params["coefficient"] = {"w": draw((D, 2), 0.02), "b": zeros(2)}
        return params

    def __call__(self, params, x, generator: Optional[torch.Generator] = None,
                 train: bool = True):
        out, l_aux, exp_counts = self.moe_layer(params, x, generator=generator, train=train)
        if self.use_residual:
            coef = params["coefficient"]
            out = residual_blend(x, out, params["residual_mlp"], coef["w"], coef["b"])
        return out, l_aux, exp_counts
