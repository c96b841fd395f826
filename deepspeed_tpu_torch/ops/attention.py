"""Plain attention reference (counterpart of ``deepspeed_tpu/ops/attention.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def mha_attention(q, k, v, mask_bias=None, causal: bool = True, alibi_slopes=None,
                  scale: Optional[float] = None):
    """q ``[B, S, H, Hd]``; k, v ``[B, S, KV, Hd]`` with KV | H → ``[B, S, H, Hd]``.

    GQA without a repeated copy: query heads are reshaped into ``[KV, G]``
    groups (head h reads kv head ``h // G``) and contracted against the
    unrepeated k/v. Logits and softmax in fp32, probabilities cast back to
    q's dtype for the second product, as the JAX reference does."""
    B, S, H, Hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Hd**-0.5
    q5 = q.reshape(B, S, KV, G, Hd)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", q5.float(), k.float()) * scale
    if alibi_slopes is not None:
        pos = torch.arange(S, device=q.device)
        dist = (pos[None, :] - pos[:, None]).float()       # kpos - qpos
        logits = logits + alibi_slopes.float().reshape(1, KV, G, 1, 1) * dist
    if causal:
        tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri, -1e9)
    if mask_bias is not None:
        logits = logits + mask_bias.float()[:, None, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs, v)
    return out.reshape(B, S, H, Hd)
