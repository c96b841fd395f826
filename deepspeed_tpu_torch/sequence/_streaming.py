"""Chunked streaming-softmax attention: the forward half of
``deepspeed_tpu/sequence/_streaming.py`` ``chunked_attention`` in plain
PyTorch.

The dense KV-cache path (``models/transformer.py _cached_attention``) streams
its softmax over key chunks when the cache is longer than
``DENSE_STREAM_THRESHOLD``, so the live memory is O(Sq x chunk) instead of
O(Sq x Smax). Keys are padded to a multiple of the chunk with a true -inf
bias (exactly zero weight); every chunk holds at least one key whose logit
is finite, so the running max never stays -inf. GQA k/v broadcast per chunk
(head h reads kv head h // (H // KV)). The backward (ring / Ulysses
sequence parallelism) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e9  # the masking constant of the JAX package's attention paths


def _pad_kv(k, v, mask_bias, chunk: int):
    Sk = k.shape[1]
    pad = (-Sk) % chunk
    if pad == 0:
        return k, v, mask_bias
    if mask_bias is None:
        mask_bias = torch.zeros((k.shape[0], Sk), dtype=torch.float32, device=k.device)
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    mask_bias = torch.nn.functional.pad(mask_bias, (0, pad), value=float("-inf"))
    return k, v, mask_bias


def chunked_attention(q, k, v, mask_bias, slopes, qpos0: int, kpos0: int, causal: bool,
                      chunk: int, out_dtype, scale: Optional[float] = None):
    """Exact softmax attention, streamed over key chunks.

    q ``[B, Sq, H, Hd]``; k/v ``[B, Sk, KV, Hd]`` with KV | H; mask_bias
    ``[B, Sk]`` additive key bias or None; slopes ``[H]`` ALiBi or None;
    qpos0 / kpos0 the global offsets of the q and k blocks. Returns ``(out
    [B, Sq, H, Hd] in out_dtype, lse [B, H, Sq])``."""
    B, Sq, H, Hd = q.shape
    rep = H // k.shape[2]
    scale = Hd**-0.5 if scale is None else scale
    chunk = min(chunk, k.shape[1])
    k, v, mask_bias = _pad_kv(k, v, mask_bias, chunk)
    q32 = q.float().transpose(1, 2)                              # [B, H, Sq, Hd]
    qpos = qpos0 + torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    o = torch.zeros((B, H, Sq, Hd), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        if rep != 1:
            kc, vc = kc.repeat_interleave(rep, dim=2), vc.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bhqd,bkhd->bhqk", q32, kc.float()) * scale
        kposc = kpos0 + c0 + torch.arange(chunk, device=q.device)
        if slopes is not None:
            dist = (kposc[None, :] - qpos[:, None]).float()
            logits = logits + slopes.float()[None, :, None, None] * dist[None, None]
        if causal:
            logits = torch.where((qpos[:, None] >= kposc[None, :])[None, None], logits,
                                 torch.full_like(logits, _NEG_INF))
        if mask_bias is not None:
            logits = logits + mask_bias[:, c0:c0 + chunk].float()[:, None, None, :]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
        m = m_new
    l_safe = l.clamp(min=1e-30)
    out = (o / l_safe[..., None]).transpose(1, 2).to(out_dtype)
    return out, m + torch.log(l_safe)
