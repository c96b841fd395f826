from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_analyzer import (
    DataAnalyzer, load_metric_index, load_metric_values)
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_sampler import (
    DeepSpeedDataSampler)
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)
