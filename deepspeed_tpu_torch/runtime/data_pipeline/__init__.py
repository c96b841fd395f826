"""Data efficiency pipeline (counterpart of
``deepspeed_tpu/runtime/data_pipeline/``): curriculum learning,
difficulty-based sampling, offline data analysis, mmap indexed datasets,
and random-LTD token dropping."""

from deepspeed_tpu_torch.runtime.data_pipeline.config import (get_curriculum_learning,
                                                              get_data_efficiency_config,
                                                              get_data_sampling)
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
