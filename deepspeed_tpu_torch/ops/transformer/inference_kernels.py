"""Inference transformer op surface: the named-op home of the generative
decode path, as ``deepspeed_tpu/ops/transformer/inference_kernels.py``.

- ``softmax_context`` -> :func:`decode_attention` (the dense decode kernel
  over the KV cache, ``ops/kernels/decode_attention.py``);
- workspace management -> :func:`init_kv_cache` and the inference engine's
  persistent decode workspace;
- rotary embedding -> :func:`apply_rotary_pos_emb`;
- the whole per-layer pipeline -> :func:`forward_cached`.
"""

from __future__ import annotations

from deepspeed_tpu_torch.models.transformer import _rope, forward_cached, init_kv_cache
from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention


def apply_rotary_pos_emb(x, positions, theta: float = 10000.0):
    """Rotary embedding on ``[B, T, H, Hd]`` at the given absolute positions."""
    return _rope(x, positions, theta)


def softmax_context(q, ck, cv, pos: int, *, pad_bias=None, alibi_slopes=None):
    """The fused decode attention op under its reference name: one new token
    per row against the appended KV cache. Raises off the kernel's envelope
    (``forward_cached`` takes the einsum path there)."""
    out = decode_attention(q, ck, cv, pos, pad_bias=pad_bias, alibi_slopes=alibi_slopes)
    if out is None:
        raise ValueError("shape outside the decode kernel envelope; use "
                         "models.transformer.forward_cached (einsum fallback)")
    return out


__all__ = ["forward_cached", "init_kv_cache", "decode_attention",
           "softmax_context", "apply_rotary_pos_emb"]
