"""Fused training transformer layer, the counterpart of
``deepspeed_tpu/ops/transformer/training_kernels.py``: the named-op surface
of the reference's ``DeepSpeedTransformerLayer`` over the port's
``models/transformer.block`` (attention through kernels A, C and D on the
card), forward only, as in the JAX package.

``stochastic_mode`` routes the input through stochastic-rounding fake
quantization at 16 bits (``ds_sr_quantize``: kernel ``sr_quantize.cu`` on
the card) with one group per batch row and a per-instance seed offset, so
stacked layers at the same step draw different rounding noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.ops.quantizer.kernels import ds_sr_quantize
from deepspeed_tpu_torch.utils.init_on_device import honors_on_device

__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer"]


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """The reference config surface (``transformer.py:32``) with the knobs
    the JAX package keeps (dropout is a model-level concern there)."""
    batch_size: int = 1
    hidden_size: int = 768
    heads: int = 12
    intermediate_size: Optional[int] = None
    seq_length: int = 512
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = True
    stochastic_mode: bool = False
    attn_dropout_ratio: float = 0.0   # accepted for parity; dropout is a
    hidden_dropout_ratio: float = 0.0  # training-loop concern in the zoo


class DeepSpeedTransformerLayer:
    """Callable encoder layer: ``layer(params, x, mask_bias=None)``, with
    ``params`` one layer subtree in the zoo layout (``init_params``)."""

    _instances = 0

    def __init__(self, config: DeepSpeedTransformerConfig):
        self.config = config
        d_ff = config.intermediate_size or 4 * config.hidden_size
        self._cfg = T.TransformerConfig(
            vocab_size=1, max_seq=config.seq_length, n_layer=1,
            n_head=config.heads, d_model=config.hidden_size, d_ff=d_ff,
            causal=False, norm="layernorm", activation="gelu",
            norm_eps=config.layer_norm_eps, attn_bias=True,
            pos_embedding="none")
        self._step = 0
        DeepSpeedTransformerLayer._instances += 1
        self._seed_offset = 104729 * DeepSpeedTransformerLayer._instances

    def __call__(self, params, x, mask_bias=None, seed: Optional[int] = None):
        """``seed`` selects the stochastic-rounding stream (default: the
        layer's own call counter)."""
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        if self.config.stochastic_mode:
            if seed is None:
                seed, self._step = self._step, self._step + 1
            x = ds_sr_quantize(x.contiguous(), groups=B, bits=16, seed=self._seed_offset + seed)
        return T.block(self._cfg, x, params, positions, mask_bias)

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=torch.float32):
        """One layer's parameters, drawn as ``models.transformer.init_params``
        draws them."""
        return T.init_params(self._cfg, generator, device=device, dtype=dtype).to_dict()["layers"][0]
