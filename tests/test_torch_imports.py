"""The port stands alone: no module of ``deepspeed_tpu_torch`` (nor
``chip_smoke.py``) imports jax, the JAX package or pydantic, and its entry
points refuse to run without a CUDA device unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

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


def test_import_leaves_jax_and_pydantic_out():
    mods = ["deepspeed_tpu_torch"] + sorted(
        "deepspeed_tpu_torch." + ".".join(p.relative_to(ROOT / "deepspeed_tpu_torch")
                                          .with_suffix("").parts)
        for p in (ROOT / "deepspeed_tpu_torch").rglob("*.py") if p.name != "__init__.py")
    assert set(TRAINING_MODULES) <= set(mods)
    assert set(GENERATE_AND_CE_MODULES) <= set(mods)
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
