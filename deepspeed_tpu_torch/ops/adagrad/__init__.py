from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad

__all__ = ["DeepSpeedCPUAdagrad"]
