"""The host library's cpu_adam entry points (``csrc/host/cpu_adam.cpp``),
the counterpart of ``deepspeed_tpu/ops/adam/cpu_adam_binding.py``, and
:func:`adam_step_plain`, the same update in fp32 torch for the tests."""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import native


def adam_step(params, grads, exp_avg, exp_avg_sq, *, lr: float, beta1: float, beta2: float,
              eps: float, weight_decay: float, adamw_mode: bool, step: int,
              param_out_bf16=None) -> None:
    """In-place fused Adam update of contiguous fp32 host buffers (numpy or
    CPU torch). ``grads`` is fp32 or bf16 words; ``param_out_bf16`` (bf16
    words) receives the updated params rounded to bf16 (the fused
    convert of the device-bound staging buffer)."""
    n = params.numel() if isinstance(params, torch.Tensor) else params.size
    p = native.buffer_ptr(params, "f32", "params")
    m = native.buffer_ptr(exp_avg, "f32", "exp_avg", n)
    v = native.buffer_ptr(exp_avg_sq, "f32", "exp_avg_sq", n)
    bits = native.is_bits16(grads)
    g = native.buffer_ptr(grads, "bits16" if bits else "f32", "grads", n)
    out = (native.buffer_ptr(param_out_bf16, "bits16", "param_out_bf16", n)
           if param_out_bf16 is not None else None)
    bias_c1 = float(1.0 - beta1**step)
    bias_c2 = float(1.0 - beta2**step)
    lib = native.get_lib()
    common = (n, lr, beta1, beta2, eps, weight_decay, int(adamw_mode), bias_c1, bias_c2)
    if bits:
        lib.ds_adam_step_bf16(p, g, m, v, out, *common)
    elif out is not None:
        lib.ds_adam_step_plus_copy(p, g, m, v, out, *common)
    else:
        lib.ds_adam_step(p, g, m, v, *common)


def adam_step_plain(params: torch.Tensor, grads: torch.Tensor, exp_avg: torch.Tensor,
                    exp_avg_sq: torch.Tensor, *, lr: float, beta1: float, beta2: float,
                    eps: float, weight_decay: float, adamw_mode: bool, step: int,
                    param_out_bf16: Optional[torch.Tensor] = None) -> None:
    """:func:`adam_step` in fp32 torch ops, in place (``grads`` fp32 or
    bf16): the native kernel's arithmetic, element by element."""
    g = grads.float()
    if not adamw_mode and weight_decay > 0.0:
        g = g + weight_decay * params
    exp_avg.mul_(beta1).add_((1.0 - beta1) * g)
    exp_avg_sq.mul_(beta2).add_((1.0 - beta2) * g * g)
    bias_c1 = float(1.0 - beta1**step)
    bias_c2 = float(1.0 - beta2**step)
    update = (exp_avg / bias_c1) / (torch.sqrt(exp_avg_sq / bias_c2) + eps)
    if adamw_mode and weight_decay > 0.0:
        update = update + weight_decay * params
    params.sub_(lr * update)
    if param_out_bf16 is not None:
        param_out_bf16.view(torch.bfloat16).copy_(params)
