"""Offline dataset analysis (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/data_analyzer.py``;
reference
``runtime/data_pipeline/data_sampling/data_analyzer.py``).

Map-reduce over worker shards, file-mediated exactly like the reference so
workers can be separate launcher processes on different hosts sharing only
the filesystem: ``run_map`` computes this worker's shard and persists it;
``run_reduce`` (any single worker, after all maps) merges every worker's
artifacts into the final files :class:`DeepSpeedDataSampler` consumes.

Both reference metric families are supported:

- ``single_value_per_sample`` — one difficulty value per sample; reduce
  concatenates worker shards and builds the difficulty → sample-ids index
  (reference ``sample_to_metric`` + ``metric_to_sample`` files).
- ``accumulate_value_over_samples`` — a running vector accumulated across
  the whole dataset (e.g. token-frequency histograms for vocabulary
  curriculum); reduce sums the worker partials.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)

SINGLE_VALUE = "single_value_per_sample"
ACCUMULATE = "accumulate_value_over_samples"


def _metric_value_path(save_path: str, metric_name: str) -> str:
    return os.path.join(save_path, f"{metric_name}_values")


def _metric_index_path(save_path: str, metric_name: str) -> str:
    return os.path.join(save_path, f"{metric_name}_index.json")


class DataAnalyzer:
    """Analyze ``dataset`` with ``metric_functions`` over ``num_workers``
    file-coordinated shards.

    ``metric_types[i]`` selects the family for metric ``i`` (default
    ``single_value_per_sample`` for every metric, the reference's default
    curriculum shape).
    """

    def __init__(self, dataset, metric_names: Sequence[str],
                 metric_functions: Sequence[Callable], save_path: str,
                 num_workers: int = 1, worker_id: int = 0,
                 batch_size: int = 1024,
                 metric_types: Optional[Sequence[str]] = None):
        self.dataset = dataset
        self.metric_names = list(metric_names)
        self.metric_functions = list(metric_functions)
        self.metric_types = (list(metric_types) if metric_types is not None
                             else [SINGLE_VALUE] * len(self.metric_names))
        if len(self.metric_types) != len(self.metric_names):
            raise ValueError("metric_types length != metric_names length")
        for t in self.metric_types:
            if t not in (SINGLE_VALUE, ACCUMULATE):
                raise ValueError(f"unknown metric type {t!r}")
        self.save_path = save_path
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.batch_size = batch_size

    def _worker_range(self):
        n = len(self.dataset)
        per = (n + self.num_workers - 1) // self.num_workers
        start = self.worker_id * per
        return start, min(n, start + per)

    # ----------------------------- map ----------------------------- #

    def run_map(self) -> None:
        """Compute metric values for this worker's shard and persist them."""
        os.makedirs(self.save_path, exist_ok=True)
        start, end = self._worker_range()
        for name, fn, mtype in zip(self.metric_names, self.metric_functions,
                                   self.metric_types):
            if mtype == SINGLE_VALUE:
                out = np.asarray([int(fn(self.dataset[i]))
                                  for i in range(start, end)], dtype=np.int64)
            else:  # ACCUMULATE: sum of per-sample vectors over the shard
                acc = None
                for i in range(start, end):
                    v = np.asarray(fn(self.dataset[i]), dtype=np.int64)
                    acc = v.copy() if acc is None else acc + v
                out = acc if acc is not None else np.zeros(0, np.int64)
            np.save(os.path.join(self.save_path,
                                 f"{name}_worker{self.worker_id}.npy"), out)

    # ---------------------------- reduce ---------------------------- #

    def run_reduce(self) -> None:
        """Merge all workers' shards into the final metric files."""
        for name, mtype in zip(self.metric_names, self.metric_types):
            parts = []
            for w in range(self.num_workers):
                path = os.path.join(self.save_path, f"{name}_worker{w}.npy")
                parts.append(np.load(path))

            if mtype == SINGLE_VALUE:
                values = np.concatenate(parts)
            else:
                width = max((p.shape[0] for p in parts), default=0)
                values = np.zeros(width, np.int64)
                for p in parts:
                    values[:p.shape[0]] += p

            builder = MMapIndexedDatasetBuilder(
                _metric_value_path(self.save_path, name), dtype=np.int64)
            builder.add_item(values)
            builder.finalize()

            if mtype == SINGLE_VALUE:
                index: Dict[int, List[int]] = {}
                for sample_id, v in enumerate(values.tolist()):
                    index.setdefault(v, []).append(sample_id)
                with open(_metric_index_path(self.save_path, name), "w") as f:
                    json.dump({str(k): v for k, v in sorted(index.items())}, f)

    def run(self) -> None:
        self.run_map()
        if self.worker_id == 0 and self.num_workers == 1:
            self.run_reduce()


def load_metric_values(save_path: str, metric_name: str) -> np.ndarray:
    ds = MMapIndexedDataset(_metric_value_path(save_path, metric_name))
    return np.asarray(ds[0])


def load_metric_index(save_path: str, metric_name: str) -> Dict[int, List[int]]:
    with open(_metric_index_path(save_path, metric_name)) as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}


def get_metric_value_percentiles(save_path: str, metric_name: str,
                                 percentiles: Sequence[float] = (10, 50, 90)):
    """Metric-value percentiles over the analyzed dataset (reference
    ``get_metric_value_percentiles`` — used to pick curriculum difficulty
    boundaries from the observed distribution)."""
    values = load_metric_values(save_path, metric_name)
    return {float(p): float(np.percentile(values, p)) for p in percentiles}
