"""Package metadata + console entry points (reference setup.py + bin/)."""

from setuptools import find_packages, setup

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native large-model training & inference framework "
                "(DeepSpeed-compatible capability surface on JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch", "deepspeed_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "ml_dtypes", "einops"],
    entry_points={
        "console_scripts": [
            "dscli=deepspeed_tpu.cli:main",
            "ds_report=deepspeed_tpu.env_report:cli_main",
        ],
    },
)
