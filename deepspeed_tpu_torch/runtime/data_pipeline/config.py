"""Data-efficiency (curriculum learning + random-LTD) config (counterpart of
``deepspeed_tpu/runtime/data_pipeline/config.py``): plain nested dicts keyed
like the reference JSON schema, with the JAX package's defaults.
"""

from __future__ import annotations

from deepspeed_tpu_torch.config.config_utils import deep_update

DATA_EFFICIENCY = "data_efficiency"
DATA_SAMPLING = "data_sampling"
CURRICULUM_LEARNING = "curriculum_learning"
DATA_ROUTING = "data_routing"
RANDOM_LTD = "random_ltd"


DEFAULT_DATA_EFFICIENCY = {
    "enabled": False,
    "seed": 1234,
    DATA_SAMPLING: {
        "enabled": False,
        "num_epochs": 1000,
        "num_workers": 0,
        CURRICULUM_LEARNING: {
            "enabled": False,
        },
    },
    DATA_ROUTING: {
        "enabled": False,
        RANDOM_LTD: {
            "enabled": False,
        },
    },
}


def get_data_efficiency_config(param_dict: dict) -> dict:
    return deep_update(DEFAULT_DATA_EFFICIENCY, param_dict.get(DATA_EFFICIENCY, {}))


def get_data_sampling(param_dict: dict) -> dict:
    return get_data_efficiency_config(param_dict)[DATA_SAMPLING]


def get_curriculum_learning(param_dict: dict) -> dict:
    return get_data_sampling(param_dict)[CURRICULUM_LEARNING]


def get_data_routing(param_dict: dict) -> dict:
    return get_data_efficiency_config(param_dict)[DATA_ROUTING]


def get_random_ltd(param_dict: dict) -> dict:
    return get_data_routing(param_dict)[RANDOM_LTD]
