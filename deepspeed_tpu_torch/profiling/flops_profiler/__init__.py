from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (FlopCounter, FlopsProfiler,
                                                                   get_model_profile,
                                                                   number_to_string)
