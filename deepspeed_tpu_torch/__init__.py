"""deepspeed_tpu_torch — the PyTorch / CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package runs the
same surface on an NVIDIA H100 with hand-written Hopper kernels. It imports
``torch``, never ``jax``, and nothing of ``deepspeed_tpu``.

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    engine = deepspeed_tpu_torch.init_inference(llama("7b"), dtype="bf16")
    outputs = engine.generate_batch(prompts, max_new_tokens=32)

    engine, optimizer, _, lr_scheduler = deepspeed_tpu_torch.initialize(
        model=llama("7b", n_layer=8), config=ds_config)
    loss = engine.train_batch({"input_ids": tokens})
"""


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config=None, config_params=None, device=None):
    """Build the training engine (counterpart of
    ``deepspeed_tpu.initialize``). Returns ``(engine, optimizer, None,
    lr_scheduler)``: the engine's dataloader is not ported, so
    ``training_data`` raises. ``device`` defaults to ``cuda:0`` and raises
    without a CUDA device; ``device="cpu"`` runs the kernels' plain
    versions (the CPU tests)."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if mpu is not None:
        raise NotImplementedError("model parallelism (mpu) is not ported to "
                                  "deepspeed_tpu_torch yet (ROADMAP.md queue 1: "
                                  "runtime/zero/ multi-rank)")
    engine = DeepSpeedEngine(model=model, config=config, model_parameters=model_parameters,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             training_data=training_data, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


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
