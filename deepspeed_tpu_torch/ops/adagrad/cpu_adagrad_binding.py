"""The host library's cpu_adagrad entry points (``csrc/host/cpu_adagrad.cpp``),
the counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad_binding.py``, and
:func:`adagrad_step_plain`, the same update in fp32 torch for the tests."""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import native


def adagrad_step(params, grads, exp_avg_sq, *, lr: float, eps: float, weight_decay: float,
                 param_out_bf16=None) -> None:
    """In-place Adagrad update of contiguous fp32 host buffers; with
    ``param_out_bf16`` (bf16 words) also the bf16 copy-out."""
    n = params.numel() if isinstance(params, torch.Tensor) else params.size
    p = native.buffer_ptr(params, "f32", "params")
    g = native.buffer_ptr(grads, "f32", "grads", n)
    h = native.buffer_ptr(exp_avg_sq, "f32", "exp_avg_sq", n)
    lib = native.get_lib()
    if param_out_bf16 is not None:
        out = native.buffer_ptr(param_out_bf16, "bits16", "param_out_bf16", n)
        lib.ds_adagrad_step_plus_copy(p, g, h, out, n, lr, eps, weight_decay)
    else:
        lib.ds_adagrad_step(p, g, h, n, lr, eps, weight_decay)


def adagrad_step_plain(params: torch.Tensor, grads: torch.Tensor, exp_avg_sq: torch.Tensor,
                       *, lr: float, eps: float, weight_decay: float,
                       param_out_bf16: Optional[torch.Tensor] = None) -> None:
    """:func:`adagrad_step` in fp32 torch ops, in place."""
    g = grads.float()
    if weight_decay > 0.0:
        g = g + weight_decay * params
    exp_avg_sq.add_(g * g)
    params.sub_(lr * g / (torch.sqrt(exp_avg_sq) + eps))
    if param_out_bf16 is not None:
        param_out_bf16.view(torch.bfloat16).copy_(params)
