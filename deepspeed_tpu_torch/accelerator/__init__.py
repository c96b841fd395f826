from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator

__all__ = ["get_accelerator"]
