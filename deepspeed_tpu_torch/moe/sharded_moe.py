"""Top-k gating and the MoE layer at expert parallelism 1 (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``; reference ``deepspeed/moe/sharded_moe.py``
``TopKGate`` :176 and ``MOELayer`` :417).

The gating keeps the GShard einsum formulation of the JAX package with a
static capacity (``drop_tokens=False`` sets capacity = tokens), so the two
packages return the same ``l_aux``, ``[T, E, C]`` combine weights, dispatch
mask and pre-truncation expert counts for the same logits wherever no random
draw is made. Randomness (RSample's gumbel noise, random token selection,
top-2's second-expert noise) comes from an explicit ``torch.Generator``:
the two packages draw different numbers, so the tests hold those paths by
their properties. The products are plain torch (einsum, ``torch.bmm``), as
the JAX package leaves them to XLA outside any Pallas kernel; at ep 1 there
is no all-to-all.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch

from deepspeed_tpu_torch.utils.logging import warn_once


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _one_hot(idx, n: int):
    """fp32 one-hot rows; an index at or past ``n`` gives a zero row, as
    ``jax.nn.one_hot`` does (a token past capacity lands in no slot)."""
    return (idx.long()[:, None] == torch.arange(n, device=idx.device)[None, :]).float()


def gumbel_noise(generator: torch.Generator, shape, device=None):
    """Gumbel(0, 1) noise from ``generator``: -log(-log(u)), u uniform in
    [1e-9, 1 - 1e-9) (the JAX package's bounds)."""
    u = torch.rand(shape, generator=generator, device=device or generator.device)
    u = 1e-9 + u * ((1.0 - 1e-9) - 1e-9)
    return -torch.log(-torch.log(u))


def top1gating(logits: torch.Tensor, capacity_factor: float = 1.0, min_capacity: int = 4,
               used_token: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
               use_rts: bool = True, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 gating: ``(l_aux, combine [T, E, C], dispatch_mask [T, E, C]
    bool, exp_counts [E])``, ``exp_counts`` taken before capacity truncation.

    ``noisy_gate_policy`` "RSample" routes on gumbel-perturbed logits
    (needs ``generator``); ``used_token`` ``[T]`` 1/0 keeps masked tokens
    out of routing and capacity; ``use_rts`` gives the capacity slots to a
    random subset of each expert's tokens, and without a generator falls
    back to positional priority with a one-time warning."""
    T, E = logits.shape
    C = T if not drop_tokens else _capacity(T, E, capacity_factor, min_capacity)
    C = min(C, T)
    gates = torch.softmax(logits.float(), dim=-1)

    route_logits = logits
    if noisy_gate_policy == "RSample":
        if generator is None:
            raise ValueError("RSample gating needs a generator")
        route_logits = logits + gumbel_noise(generator, logits.shape, logits.device)
    mask1 = _one_hot(torch.argmax(route_logits, dim=-1), E)
    if used_token is not None:
        mask1 = mask1 * used_token.float()[:, None]

    # load-balancing loss: E * sum_e mean_gate_e * mean_count_e
    l_aux = torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * E
    # the load before capacity truncation: the monitoring signal shows overflow
    exp_counts = mask1.sum(dim=0).to(torch.int32)

    if use_rts and generator is None:
        warn_once("top1gating: use_rts=True but no generator was given; falling back to "
                  "positional capacity priority")
        use_rts = False
    if use_rts:
        scores = torch.rand((T,), generator=generator, device=logits.device)
        order = torch.argsort(scores)            # a random permutation of token priority
        prio = mask1[order]
        loc_sorted = torch.cumsum(prio, dim=0) - prio
        locations1 = torch.sum(loc_sorted[torch.argsort(order)] * mask1, dim=1)
    else:
        loc = torch.cumsum(mask1, dim=0) - mask1
        locations1 = torch.sum(loc * mask1, dim=1)

    keep = (locations1 < C).float() * mask1.sum(dim=1)
    mask1 = mask1 * keep[:, None]
    gates1 = torch.sum(gates * mask1, dim=1)      # the selected gate value, 0 if dropped
    combine = gates1[:, None, None] * mask1[:, :, None] * _one_hot(locations1, C)[:, None, :]
    return l_aux, combine, combine > 0, exp_counts


def top2gating(logits: torch.Tensor, capacity_factor: float = 1.0, min_capacity: int = 4,
               drop_tokens: bool = True, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 gating: the second expert from the logits (gumbel-perturbed
    when ``generator`` is given) with the first masked out; the two gate
    values renormalised; capacity from twice the factor; first-choice
    tokens take the slots before second-choice ones."""
    T, E = logits.shape
    C = T if not drop_tokens else _capacity(T, E, 2 * capacity_factor, min_capacity)
    C = min(C, T)
    gates = torch.softmax(logits.float(), dim=-1)
    mask1 = _one_hot(torch.argmax(gates, dim=-1), E)

    logits2 = logits.float()
    if generator is not None:
        logits2 = logits2 + gumbel_noise(generator, logits.shape, logits.device)
    logits2 = torch.where(mask1 > 0, float("-inf"), logits2)
    mask2 = _one_hot(torch.argmax(logits2, dim=-1), E)

    loc1 = torch.cumsum(mask1, dim=0) - mask1
    loc2 = torch.cumsum(mask2, dim=0) - mask2 + mask1.sum(dim=0, keepdim=True)
    l_aux = torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * E
    exp_counts = mask1.sum(dim=0).to(torch.int32)

    locations1 = torch.sum(loc1 * mask1, dim=1)
    locations2 = torch.sum(loc2 * mask2, dim=1)
    mask1 = mask1 * (locations1 < C).float()[:, None]
    mask2 = mask2 * (locations2 < C).float()[:, None]
    g1 = torch.sum(gates * mask1, dim=1)
    g2 = torch.sum(gates * mask2, dim=1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    combine = (g1[:, None, None] * mask1[:, :, None] * _one_hot(locations1, C)[:, None, :]
               + g2[:, None, None] * mask2[:, :, None] * _one_hot(locations2, C)[:, None, :])
    return l_aux, combine, combine > 0, exp_counts


class TopKGate:
    """A linear router and top-k gating; ``params`` = ``{"wg": [D, E]}``."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True):
        if k not in (1, 2):
            raise ValueError("TopKGate supports k=1 or k=2")
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts

    def init(self, generator: Optional[torch.Generator] = None, device="cpu",
             dtype=torch.float32):
        w = torch.randn((self.model_dim, self.num_experts), generator=generator, device=device)
        return {"wg": (w / math.sqrt(self.model_dim)).to(dtype)}

    def __call__(self, params, tokens, used_token=None,
                 generator: Optional[torch.Generator] = None, train: bool = True):
        """tokens ``[T, D]`` -> ``(l_aux, combine, dispatch, exp_counts)``.
        Jitter multiplies the tokens by U(0.99, 1.01) in training; RTS is a
        training regularizer, so eval routes deterministically."""
        x = tokens
        if train and self.noisy_gate_policy == "Jitter" and generator is not None:
            x = x * (0.99 + 0.02 * torch.rand(x.shape, generator=generator, device=x.device))
        logits = x.float() @ params["wg"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity, used_token,
                              self.noisy_gate_policy if train else None, self.drop_tokens,
                              self.use_rts and train, generator)
        return top2gating(logits, cf, self.min_capacity, self.drop_tokens, generator)


def dispatch_combine(tokens: torch.Tensor, combine: torch.Tensor, dispatch: torch.Tensor,
                     expert_fn: Callable, expert_params: Any) -> torch.Tensor:
    """Dispatch -> expert compute -> combine: ``tokens [T, D]`` and
    ``combine / dispatch [T, E, C]`` -> ``[T, D]``. ``expert_fn(params,
    x [E, C, D]) -> [E, C, D]`` runs every expert at once over the stacked
    parameters (the JAX package vmaps a one-expert function over them)."""
    dispatched = torch.einsum("tec,td->ecd", dispatch.to(tokens.dtype), tokens)
    expert_out = expert_fn(expert_params, dispatched)
    return torch.einsum("tec,ecd->td", combine.to(tokens.dtype), expert_out)


class MOELayer:
    """Gate -> dispatch -> experts -> combine. ``expert_fn(params, x [E, C,
    D]) -> [E, C, D]`` over the stacked expert parameters."""

    def __init__(self, gate: TopKGate, expert_fn: Callable, num_local_experts: int = 1):
        self.gate = gate
        self.expert_fn = expert_fn
        self.num_local_experts = num_local_experts

    def __call__(self, params, x, generator: Optional[torch.Generator] = None,
                 train: bool = True):
        """x ``[B, S, D]`` (or ``[T, D]``) -> ``(out, l_aux, exp_counts)``."""
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])
        l_aux, combine, dispatch, exp_counts = self.gate(params["gate"], tokens,
                                                         generator=generator, train=train)
        out = dispatch_combine(tokens, combine, dispatch, self.expert_fn, params["experts"])
        return out.reshape(shape), l_aux, exp_counts
