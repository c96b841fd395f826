"""Elasticity config (counterpart of ``deepspeed_tpu/elasticity/config.py``;
reference ``deepspeed/elasticity/config.py``)."""

from __future__ import annotations

import json

from deepspeed_tpu_torch.config import constants as C


class ElasticityError(Exception):
    """Base exception for elasticity errors."""


class ElasticityConfigError(ElasticityError):
    """Elasticity configuration error."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """World size is not compatible with the elastic config."""


class ElasticityConfig:
    """Elastic config object: which batch sizes are valid across which
    device-count ranges, so checkpoints stay consistent as world size changes.

    JSON schema (same as reference)::

        "elasticity": {
            "enabled": true,
            "max_train_batch_size": 2000,
            "micro_batch_sizes": [2,4,6],
            "min_gpus": 1, "max_gpus": 10000,
            "min_time": 20,
            "prefer_larger_batch": true,
            "ignore_non_elastic_batch_info": false,
            "version": 0.2
        }
    """

    def __init__(self, param_dict: dict):
        self.enabled = param_dict.get(C.ENABLED, C.ENABLED_DEFAULT)
        if self.enabled:
            if C.MAX_ACCEPTABLE_BATCH_SIZE in param_dict:
                self.max_acceptable_batch_size = param_dict[C.MAX_ACCEPTABLE_BATCH_SIZE]
            else:
                raise ElasticityConfigError(
                    f"Elasticity config missing {C.MAX_ACCEPTABLE_BATCH_SIZE}")
            if C.MICRO_BATCHES in param_dict:
                self.micro_batches = param_dict[C.MICRO_BATCHES]
            else:
                raise ElasticityConfigError(f"Elasticity config missing {C.MICRO_BATCHES}")
        else:
            self.max_acceptable_batch_size = param_dict.get(C.MAX_ACCEPTABLE_BATCH_SIZE,
                                                            C.MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT)
            self.micro_batches = param_dict.get(C.MICRO_BATCHES, C.MICRO_BATCHES_DEFAULT)

        if not isinstance(self.micro_batches, list):
            raise ElasticityConfigError(
                f"Elasticity expected value of {C.MICRO_BATCHES} to be a "
                f"list of micro batches, instead is: {type(self.micro_batches)}, "
                f"containing: {self.micro_batches}")
        if not all(map(lambda m: isinstance(m, int), self.micro_batches)):
            raise ElasticityConfigError(
                f"Elasticity expected {C.MICRO_BATCHES} to only contain a list of integers, "
                f"instead contains: f{self.micro_batches}")
        if not all(map(lambda m: m > 0, self.micro_batches)):
            raise ElasticityConfigError(
                f"Elasticity expected {C.MICRO_BATCHES} to only contain positive integers, "
                f"instead contains: f{self.micro_batches}")

        self.min_gpus = param_dict.get(C.MIN_GPUS, C.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(C.MAX_GPUS, C.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < 1:
            raise ElasticityConfigError(
                "Elasticity min/max gpus must be > 0, "
                f"given min_gpus: {self.min_gpus}, max_gpus: {self.max_gpus}")
        if self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                "Elasticity min_gpus cannot be greater than max_gpus, "
                f"given min_gpus: {self.min_gpus}, max_gpus: {self.max_gpus}")

        self.model_parallel_size = param_dict.get(C.MODEL_PARALLEL_SIZE,
                                                  C.MODEL_PARALLEL_SIZE_DEFAULT)
        if self.model_parallel_size < 1:
            raise ElasticityConfigError("Model-Parallel size cannot be less than 1, "
                                        f"given model-parallel size: {self.model_parallel_size}")

        self.num_gpus_per_node = param_dict.get(C.NUM_GPUS_PER_NODE, C.NUM_GPUS_PER_NODE_DEFAULT)
        if self.num_gpus_per_node < 1:
            raise ElasticityConfigError(
                "Number of GPUs per node cannot be less than 1, "
                f"given number of GPUs per node: {self.num_gpus_per_node}")

        self.min_time = param_dict.get(C.MIN_TIME, C.MIN_TIME_DEFAULT)
        if self.min_time < 0:
            raise ElasticityConfigError(
                f"Elasticity min time needs to be >= 0: given {self.min_time}")

        self.version = param_dict.get(C.VERSION, C.ELASTICITY_DEFAULT_VERSION)
        self.prefer_larger_batch_size = param_dict.get(C.PREFER_LARGER_BATCH,
                                                       C.PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(C.IGNORE_NON_ELASTIC_BATCH_INFO,
                                                            C.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
