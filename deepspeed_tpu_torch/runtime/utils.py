"""Gradient norms and clipping (the training subset of
``deepspeed_tpu/runtime/utils.py``: ``global_norm`` :111, ``clip_grad_norm_``
:118) over a list of tensors instead of a pytree."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, as a 0-dim
    tensor on the tensors' device (no host sync). ``tensors`` may be a
    generator: each is reduced before the next is drawn."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    if not norms:
        return torch.tensor(0.0)
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def clip_grad_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                    norm: Optional[torch.Tensor] = None) -> Tuple[Sequence[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place to global norm at most ``max_norm``:
    ``g * min(1, max_norm / (norm + 1e-6))`` with ``norm`` the pre-clip
    global norm (computed when not given). Returns ``(grads, norm)``."""
    norm = global_norm(grads) if norm is None else norm
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return grads, norm
