from deepspeed_tpu_torch.ops.lamb.fused_lamb_kernel import fused_lamb_step, lamb_group_step

__all__ = ["fused_lamb_step", "lamb_group_step"]
