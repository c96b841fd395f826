"""deepspeed_tpu_torch — the PyTorch / CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package runs the
same surface on an NVIDIA H100 with hand-written Hopper kernels. It imports
``torch``, never ``jax``, and nothing of ``deepspeed_tpu``.

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    engine = deepspeed_tpu_torch.init_inference(llama("7b"), dtype="bf16")
    outputs = engine.generate_batch(prompts, max_new_tokens=32)

    engine, optimizer, loader, lr_scheduler = deepspeed_tpu_torch.initialize(
        model=llama("7b", n_layer=8), config=ds_config, training_data=dataset)
    loss = engine.train_batch()              # from the engine's dataloader
    engine.save_checkpoint("ckpt")           # the JAX package's crash-safe tags
    engine.auto_resume("ckpt")               # in a new process: exact resume

    engine = deepspeed_tpu_torch.init_inference("Llama-2-7b-hf/", dtype="bf16")

The exports below load lazily, so ``import deepspeed_tpu_torch`` builds no
kernel and imports no model code.
"""

from deepspeed_tpu_torch.version import __version__, git_branch, git_hash  # noqa: F401

_LAZY_EXPORTS = {
    "DeepSpeedEngine": ("deepspeed_tpu_torch.runtime.engine", "DeepSpeedEngine"),
    "InferenceEngine": ("deepspeed_tpu_torch.inference.engine", "InferenceEngine"),
    "DeepSpeedInferenceConfig": ("deepspeed_tpu_torch.inference.config",
                                 "DeepSpeedInferenceConfig"),
    "DeepSpeedConfig": ("deepspeed_tpu_torch.config.core", "DeepSpeedConfig"),
    "DeepSpeedConfigError": ("deepspeed_tpu_torch.config.core", "DeepSpeedConfigError"),
    "DeepSpeedTransformerLayer": ("deepspeed_tpu_torch.ops.transformer.training_kernels",
                                  "DeepSpeedTransformerLayer"),
    "DeepSpeedTransformerConfig": ("deepspeed_tpu_torch.ops.transformer.training_kernels",
                                   "DeepSpeedTransformerConfig"),
    "log_dist": ("deepspeed_tpu_torch.utils.logging", "log_dist"),
    "add_tuning_arguments": ("deepspeed_tpu_torch.runtime.lr_schedules",
                             "add_tuning_arguments"),
    "checkpointing": ("deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing",
                      None),
    "module_inject": ("deepspeed_tpu_torch.module_inject", None),
    "OnDevice": ("deepspeed_tpu_torch.utils.init_on_device", "OnDevice"),
    # deepspeed.zero.Init / GatheredParameters
    "zero": ("deepspeed_tpu_torch.runtime.zero", None),
}


def __getattr__(name):
    entry = _LAZY_EXPORTS.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(entry[0])
    obj = mod if entry[1] is None else getattr(mod, entry[1])
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(list(globals()) + list(_LAZY_EXPORTS))


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config=None, config_params=None, device=None):
    """Build the training engine (counterpart of
    ``deepspeed_tpu.initialize``). Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``; the dataloader batches
    ``training_data`` (None without it). ``device`` defaults to ``cuda:0``
    and raises without a CUDA device; ``device="cpu"`` runs the kernels'
    plain versions (the CPU tests). Under the launcher (``python -m
    deepspeed_tpu_torch.cli run``) the engine joins the process group
    (``comm.init_distributed``: nccl, or gloo on the CPU) and trains
    data-parallel over the config's mesh, partitioning its state at ZeRO
    stages 1-3. ``mpu``: its ``get_data_parallel_world_size()`` is the
    data-parallel world (the reference contract), which must equal the
    process group's; a model-parallel world above 1 is not ported."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    engine = DeepSpeedEngine(model=model, config=config, model_parameters=model_parameters,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             training_data=training_data, collate_fn=collate_fn,
                             device=device, mpu=mpu)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model, config=None, params=None, device=None, **kwargs):
    """Build the serving engine (counterpart of
    ``deepspeed_tpu.init_inference``). ``params`` (a parameter tree) supplies
    the weights explicitly; else ``model`` given as an HF checkpoint path, or
    ``checkpoint`` (an HF path, or a Megatron meta json as a path or dict),
    loads them; else the model's seeded random init runs.
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


def add_config_arguments(parser):
    """Add --deepspeed / --deepspeed_config CLI args."""
    group = parser.add_argument_group("DeepSpeed-TPU", "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU (helper flag to ease transition)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the framework json config file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated alias of --deepspeed")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated alias of --deepspeed_config")
    return parser
