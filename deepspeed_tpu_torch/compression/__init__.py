"""Compression (reference ``deepspeed/compression/``; the port of
``deepspeed_tpu/compression/``): QAT quantization, structured and
unstructured pruning, schedule-gated activation, layer reduction, and
redundancy_clean for deployment."""

from deepspeed_tpu_torch.compression.compress import (CompressedModel, init_compression,
                                                      redundancy_clean,
                                                      student_initialization)
from deepspeed_tpu_torch.compression.config import get_compression_config
from deepspeed_tpu_torch.compression.functional import (channel_mask, fake_quantize,
                                                        head_mask, prune,
                                                        quantize_activation, row_mask,
                                                        sparse_mask)
from deepspeed_tpu_torch.compression.scheduler import CompressionScheduler

__all__ = [
    "init_compression", "redundancy_clean", "student_initialization",
    "CompressedModel", "CompressionScheduler",
    "get_compression_config", "fake_quantize", "quantize_activation", "prune",
    "sparse_mask", "row_mask", "channel_mask", "head_mask",
]
