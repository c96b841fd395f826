"""deepspeed_tpu_torch — the PyTorch / CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package runs the
same surface on an NVIDIA H100 with hand-written Hopper kernels. It imports
``torch``, never ``jax``, and nothing of ``deepspeed_tpu``.

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    engine = deepspeed_tpu_torch.init_inference(llama("7b"), dtype="bf16")
    outputs = engine.generate_batch(prompts, max_new_tokens=32)
"""


def init_inference(model, config=None, params=None, device=None, **kwargs):
    """Build the serving engine (counterpart of
    ``deepspeed_tpu.init_inference``). ``params`` (a parameter tree) supplies
    the weights explicitly; without it the model's seeded random init runs.
    ``device`` defaults to ``cuda:0`` and raises without a CUDA device;
    ``device="cpu"`` runs the kernels' plain versions (the CPU tests)."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    config = dict(kwargs) if config is None else {**config, **kwargs}
    if "params" in config:
        # weights riding in the config dict are honored, never dropped
        cfg_params = config.pop("params")
        if params is None:
            params = cfg_params
    return InferenceEngine(model, config=DeepSpeedInferenceConfig(**config),
                           params=params, device=device)
