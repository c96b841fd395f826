from deepspeed_tpu_torch.ops.aio.aio_binding import (ALIGN, AsyncIOHandle, HostSlab,
                                                     aligned_tensor, padded_numel)

__all__ = ["ALIGN", "AsyncIOHandle", "HostSlab", "aligned_tensor", "padded_numel"]
