from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

__all__ = ["HostOffloadOptimizer"]
