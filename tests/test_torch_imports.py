"""The port stands alone: no module of ``deepspeed_tpu_torch`` (nor
``chip_smoke.py``) imports jax, the JAX package or pydantic, and its entry
points refuse to run without a CUDA device unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu", "pydantic")


def _port_sources():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_forbidden_imports():
    files = _port_sources()
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: import {mod}")
    assert not bad, bad


# the training slice's modules, which the import check below must cover
TRAINING_MODULES = (
    "deepspeed_tpu_torch.config.constants", "deepspeed_tpu_torch.config.precision",
    "deepspeed_tpu_torch.config.core", "deepspeed_tpu_torch.runtime.utils",
    "deepspeed_tpu_torch.runtime.loss_scaler", "deepspeed_tpu_torch.runtime.lr_schedules",
    "deepspeed_tpu_torch.runtime.optimizers", "deepspeed_tpu_torch.runtime.engine",
    "deepspeed_tpu_torch.ops.adam.fused_adam_kernel",
)


# the third slice's modules (static generate with K5, fused CE K3)
GENERATE_AND_CE_MODULES = (
    "deepspeed_tpu_torch.ops.kernels.decode_attention",
    "deepspeed_tpu_torch.ops.kernels.fused_cross_entropy",
    "deepspeed_tpu_torch.ops.transformer.inference_kernels",
    "deepspeed_tpu_torch.sequence._streaming",
)


# the fourth slice's modules (LAMB on K7, MoQ with K8, the training layer)
LAMB_AND_MOQ_MODULES = (
    "deepspeed_tpu_torch.ops.lamb.fused_lamb_kernel",
    "deepspeed_tpu_torch.ops.quantizer.kernels",
    "deepspeed_tpu_torch.ops.transformer.training_kernels",
    "deepspeed_tpu_torch.runtime.quantize",
)


# the sparse-attention slice's modules
SPARSE_MODULES = (
    "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config",
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention",
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils",
    "deepspeed_tpu_torch.ops.sparse_attention.kernels",
)


# the speculative-decoding slice's modules
SPEC_MODULES = (
    "deepspeed_tpu_torch.inference.spec",
)


# the resumable-training slice's modules (dataloader, checkpoints, entry surface)
RESUME_MODULES = (
    "deepspeed_tpu_torch.utils.pytree", "deepspeed_tpu_torch.utils.fault_injection",
    "deepspeed_tpu_torch.runtime.dataloader",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.engine",
    "deepspeed_tpu_torch.models.presets",
)


# the checkpoint-ingestion slice's modules (checkpoint/ tools, module_inject/)
INGEST_MODULES = (
    "deepspeed_tpu_torch.checkpoint._safetensors", "deepspeed_tpu_torch.checkpoint.reshape_utils",
    "deepspeed_tpu_torch.checkpoint.state_dict_factory",
    "deepspeed_tpu_torch.checkpoint.zero_to_fp32",
    "deepspeed_tpu_torch.checkpoint.universal_checkpoint",
    "deepspeed_tpu_torch.checkpoint.reshape_pipeline",
    "deepspeed_tpu_torch.module_inject.policies", "deepspeed_tpu_torch.module_inject.loader",
    "deepspeed_tpu_torch.module_inject.megatron",
)


# the telemetry slice's modules (monitor/, the timers)
MONITOR_MODULES = (
    "deepspeed_tpu_torch.monitor.config", "deepspeed_tpu_torch.monitor.metrics",
    "deepspeed_tpu_torch.monitor.events", "deepspeed_tpu_torch.monitor.trace",
    "deepspeed_tpu_torch.monitor.monitor", "deepspeed_tpu_torch.monitor.health",
    "deepspeed_tpu_torch.utils.timer",
)


# the client-optimizer and control-plane slice's modules; all but health do
# host-side dict work only and touch no torch.cuda API
CONTROL_PLANE_MODULES = (
    "deepspeed_tpu_torch.monitor.exporter", "deepspeed_tpu_torch.monitor.sampler",
    "deepspeed_tpu_torch.monitor.slo", "deepspeed_tpu_torch.monitor.controller",
    "deepspeed_tpu_torch.monitor.anatomy", "deepspeed_tpu_torch.monitor.top",
    "deepspeed_tpu_torch.cli",
)


# the async serving slice's modules: the front-end and the step faults; both
# are host code and name no torch.cuda API
ASYNC_SERVING_MODULES = (
    "deepspeed_tpu_torch.inference.serve", "deepspeed_tpu_torch.utils.fault_injection",
)


def test_async_serving_imports_no_jax_nor_cuda():
    """``inference/serve.py`` and ``utils/fault_injection.py`` keep their own
    copies of the JAX host code: importing them loads neither jax, the JAX
    package nor pydantic, and neither names a ``torch.cuda`` API."""
    for name in ASYNC_SERVING_MODULES:
        path = ROOT / (name.replace(".", "/") + ".py")
        assert "torch.cuda" not in path.read_text(), name
        assert not any(m.split(".")[0] in FORBIDDEN for m in _imported_modules(path)), name
    code = ("import importlib, sys\n"
            f"for m in {ASYNC_SERVING_MODULES!r}: importlib.import_module(m)\n"
            "from deepspeed_tpu_torch.inference import AsyncServingEngine, RequestHandle\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


# the tiered KV cache and replica slice's modules: the host pool (its copy
# stream is the one CUDA API it names, created inside put on the card) and the
# router, host code only
TIER_AND_ROUTER_MODULES = (
    "deepspeed_tpu_torch.inference.kv_host_pool", "deepspeed_tpu_torch.inference.router",
)


def test_tier_and_router_import_no_jax_nor_the_jax_package():
    """``inference/kv_host_pool.py`` and ``inference/router.py`` import
    neither jax, the JAX package nor pydantic; the router names no
    ``torch.cuda`` API and importing the pool touches no device."""
    for name in TIER_AND_ROUTER_MODULES:
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not any(m.split(".")[0] in FORBIDDEN for m in _imported_modules(path)), name
    assert "torch.cuda" not in (ROOT / "deepspeed_tpu_torch/inference/router.py").read_text()
    code = ("import importlib, sys, torch\n"
            f"for m in {TIER_AND_ROUTER_MODULES!r}: importlib.import_module(m)\n"
            "from deepspeed_tpu_torch.inference import KvHostPool\n"
            "assert not torch.cuda.is_initialized()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


# the MoE slice's modules (moe/, the MoE causal LM)
MOE_MODULES = (
    "deepspeed_tpu_torch.moe.utils", "deepspeed_tpu_torch.moe.sharded_moe",
    "deepspeed_tpu_torch.moe.experts", "deepspeed_tpu_torch.moe.layer",
    "deepspeed_tpu_torch.models.moe_lm",
)


# the multi-process slice's modules: comm/, the launcher, the collective
# benchmarks, the elastic agent, the group helpers and the comms logger
MULTI_PROCESS_MODULES = (
    "deepspeed_tpu_torch.comm", "deepspeed_tpu_torch.comm.comm", "deepspeed_tpu_torch.comm.mesh",
    "deepspeed_tpu_torch.comm.config", "deepspeed_tpu_torch.launcher.runner",
    "deepspeed_tpu_torch.launcher.launch", "deepspeed_tpu_torch.launcher.multinode_runner",
    "deepspeed_tpu_torch.benchmarks.comm_bench", "deepspeed_tpu_torch.elasticity.elastic_agent",
    "deepspeed_tpu_torch.utils.groups", "deepspeed_tpu_torch.utils.comms_logging",
    "deepspeed_tpu_torch.version",
)


def test_multi_process_modules_import_no_jax_nor_the_jax_package():
    """``comm/``, ``launcher/``, ``benchmarks/`` and
    ``elasticity/elastic_agent.py`` import neither jax, the JAX package nor
    pydantic, and importing them creates no process group and touches no
    device."""
    for name in MULTI_PROCESS_MODULES:
        path = ROOT / (name.replace(".", "/") + ".py")
        path = path if path.exists() else path.with_suffix("") / "__init__.py"
        assert not any(m.split(".")[0] in FORBIDDEN for m in _imported_modules(path)), name
    code = ("import importlib, sys, torch\n"
            f"for m in {MULTI_PROCESS_MODULES!r}: importlib.import_module(m)\n"
            "import torch.distributed as d\n"
            "assert not torch.cuda.is_initialized() and not d.is_initialized()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_import_leaves_jax_and_pydantic_out():
    mods = ["deepspeed_tpu_torch"] + sorted(
        "deepspeed_tpu_torch." + ".".join(p.relative_to(ROOT / "deepspeed_tpu_torch")
                                          .with_suffix("").parts)
        for p in (ROOT / "deepspeed_tpu_torch").rglob("*.py") if p.name != "__init__.py")
    assert set(TRAINING_MODULES) <= set(mods)
    assert set(GENERATE_AND_CE_MODULES) <= set(mods)
    assert set(LAMB_AND_MOQ_MODULES) <= set(mods)
    assert set(SPARSE_MODULES) <= set(mods)
    assert set(SPEC_MODULES) <= set(mods)
    assert set(RESUME_MODULES) <= set(mods)
    assert set(INGEST_MODULES) <= set(mods)
    assert set(MONITOR_MODULES) <= set(mods)
    assert set(CONTROL_PLANE_MODULES) <= set(mods)
    assert set(ASYNC_SERVING_MODULES) <= set(mods)
    assert set(TIER_AND_ROUTER_MODULES) <= set(mods)
    assert set(MOE_MODULES) <= set(mods)
    assert set(MULTI_PROCESS_MODULES) - {"deepspeed_tpu_torch.comm"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_ingestion_imports_no_checkpoint_package_and_resolves_lazily():
    """The card's machine has no safetensors, transformers or ml_dtypes:
    the ingestion modules import none of them (nor jax or the JAX package),
    and ``deepspeed_tpu_torch.module_inject`` loads only when first read."""
    absent = FORBIDDEN + ("safetensors", "transformers", "ml_dtypes")
    code = ("import sys\n"
            "import deepspeed_tpu_torch\n"
            "assert 'deepspeed_tpu_torch.module_inject' not in sys.modules\n"
            "mi = deepspeed_tpu_torch.module_inject\n"
            "assert mi is sys.modules['deepspeed_tpu_torch.module_inject']\n"
            "assert 'module_inject' in dir(deepspeed_tpu_torch)\n"
            "import deepspeed_tpu_torch.checkpoint, deepspeed_tpu_torch.module_inject.megatron\n"
            "assert callable(mi.load_hf_checkpoint) and 'llama' in mi.POLICIES\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{absent!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_monitor_imports_no_jax_nor_the_jax_package():
    """``deepspeed_tpu_torch.monitor`` keeps its own copies of the JAX
    package's standard-library monitor modules: importing all of them (and
    the package) loads neither jax, the JAX package nor pydantic, nor any
    TensorBoard / W&B package."""
    absent = FORBIDDEN + ("tensorboard", "wandb")
    code = ("import importlib, sys\n"
            "import deepspeed_tpu_torch.monitor as m\n"
            f"for name in {MONITOR_MODULES!r}: importlib.import_module(name)\n"
            "assert 'deepspeed_tpu_torch.monitor' in sys.modules and m.get_registry()\n"
            "print(sorted(x for x in sys.modules if x.split('.')[0] in "
            f"{absent!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_control_plane_imports_no_jax_nor_cuda():
    """The health module, the exposition plane and the CLI load neither jax,
    the JAX package nor pydantic; the plane's modules and the CLI name no
    ``torch.cuda`` API (health's sentinels are its only tensor code)."""
    for name in CONTROL_PLANE_MODULES:
        path = ROOT / (name.replace(".", "/") + ".py")
        assert "torch.cuda" not in path.read_text(), name
        assert not any(m.split(".")[0] in FORBIDDEN + ("torch",)
                       for m in _imported_modules(path)), name
    mods = ("deepspeed_tpu_torch.monitor.health",) + CONTROL_PLANE_MODULES
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_init_inference_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    model = llama("tiny", n_layer=1, d_model=64, n_head=1, d_ff=64, vocab_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model, dtype="fp32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cuda")
    engine = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu")
    assert engine.device.type == "cpu"


def test_initialize_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    model = llama("tiny", n_layer=1, d_model=64, n_head=1, d_ff=64, vocab_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=model, config={"train_batch_size": 1})
    engine, optimizer, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 1}, device="cpu")
    assert engine.device.type == "cpu" and optimizer is engine.optimizer
    assert loader is None and sched is None


def test_kernel_wrappers_refuse_unsupported_cuda_inputs_without_fallback():
    """The wrappers take the plain version for CPU tensors only: any other
    device either launches the kernel or raises (no quiet fallback)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(q, q, q)
    qd = torch.zeros((1, 2, 64), device="meta")
    kp = torch.zeros((2, 128, 2, 64), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        pda.paged_decode_attention(qd, kp, kp, bt, torch.zeros(1, dtype=torch.int32,
                                                               device="meta"))
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    rows = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention_dq(q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention_dkv(q, q, q, q, rows, rows)
    flat = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fad.fused_adam_step(flat, flat, flat, flat, step=1)
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
    ck = torch.zeros((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dda.decode_attention(qd, ck, ck, 0)
    h, w = torch.zeros((4, 8), device="meta"), torch.zeros((8, 16), device="meta")
    lab = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fce.fused_ce_fwd(h, w, None, lab)
    with pytest.raises(ValueError, match="no kernel for device"):
        fce.fused_ce_ds(h, w, None, lab, lab.float(), lab.float())
    with pytest.raises(ValueError, match="no kernel for device"):
        fce.fused_ce_dh(h, w.T)
    with pytest.raises(ValueError, match="no kernel for device"):
        fce.fused_ce_dw(h, h, w)
    from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    with pytest.raises(ValueError, match="no kernel for device"):
        fl.fused_lamb_step(flat, flat, flat, flat, step=1)
    with pytest.raises(ValueError, match="no kernel for device"):
        qk.ds_sr_quantize(h, 4)
