"""The port's host library (``deepspeed_tpu_torch/csrc/host/``, built by
``ops/native.py``) on the CPU: the counterparts of
``tests/unit/ops/test_aio.py`` and ``tests/unit/ops/test_cpu_adam.py`` on
the port's own build. The sources are the JAX package's and the flags its
flags and ``-fno-math-errno`` (which lets the update loops vectorize and
changes no result), so the port's ``cpu_adam`` and ``cpu_adagrad`` are
bit-equal to the JAX package's ``DeepSpeedCPUAdam`` and
``DeepSpeedCPUAdagrad`` on the same inputs; both are also held to their plain torch twins and to a numpy
reference at the JAX tests' tolerances (rtol 1e-5, atol 1e-6). A failed
build raises with the compiler's output."""

import subprocess

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adagrad import DeepSpeedCPUAdagrad as JaxCPUAdagrad
from deepspeed_tpu.ops.adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad_binding import (adagrad_step,
                                                                 adagrad_step_plain)
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.cpu_adam_binding import adam_step, adam_step_plain
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, aligned_tensor

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def ref_adam(p, g, m, v, lr, b1, b2, eps, wd, adamw, steps):
    p, m, v = p.copy(), m.copy(), v.copy()
    for t in range(1, steps + 1):
        grad = g if adamw or wd == 0 else g + wd * p
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        upd = (m / (1 - b1**t)) / (np.sqrt(v / (1 - b2**t)) + eps)
        if adamw and wd > 0:
            upd = upd + wd * p
        p = p - lr * upd
    return p, m, v


# ------------------------------------------------------------------ aio

def test_sync_pwrite_pread_roundtrip(tmp_path):
    h = AsyncIOHandle(block_size=4096, thread_count=4)
    n = 3000  # unpadded on purpose: the buffered path
    src = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    h.sync_pwrite(src, str(tmp_path / "t.bin"))
    dst = torch.empty_like(src)
    h.sync_pread(dst, str(tmp_path / "t.bin"))
    assert torch.equal(src, dst)
    # aligned and padded: O_DIRECT where the file system takes it
    buf = aligned_tensor(n)
    assert buf.data_ptr() % 4096 == 0 and buf.numel() * 4 % 4096 == 0
    buf[:n] = src
    h.sync_pwrite(buf, str(tmp_path / "t2.bin"))
    out = aligned_tensor(n)
    h.sync_pread(out, str(tmp_path / "t2.bin"))
    assert torch.equal(out[:n], src)
    # numpy buffers take the same path
    arr = np.zeros(n, np.float32)
    h.sync_pread(arr, str(tmp_path / "t.bin"))
    np.testing.assert_array_equal(arr, src.numpy())
    h.close()


def test_async_many_files(tmp_path):
    h = AsyncIOHandle(block_size=1 << 14, thread_count=8)
    srcs = [torch.full((5000,), float(i)) for i in range(8)]
    for i, s in enumerate(srcs):
        h.async_pwrite(s, str(tmp_path / f"{i}.bin"))
    h.wait()
    dsts = [torch.empty(5000) for _ in range(8)]
    for i, d in enumerate(dsts):
        h.async_pread(d, str(tmp_path / f"{i}.bin"))
    h.wait()
    assert all(torch.equal(d, s) for d, s in zip(dsts, srcs))


def test_read_missing_file_raises(tmp_path):
    h = AsyncIOHandle()
    h.async_pread(torch.empty(100), str(tmp_path / "nope.bin"))
    with pytest.raises(IOError):
        h.wait()


def test_buffers_are_checked_before_native_code():
    h = AsyncIOHandle()
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pwrite(torch.zeros(8, 8).t(), "/nonexistent")
    with pytest.raises(TypeError, match="float32"):
        adam_step(torch.zeros(4, dtype=torch.float64), torch.zeros(4), torch.zeros(4),
                  torch.zeros(4), lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.0, adamw_mode=True, step=1)
    with pytest.raises(ValueError, match="elements"):
        adam_step(torch.zeros(4), torch.zeros(3), torch.zeros(4), torch.zeros(4), lr=1e-3,
                  beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True, step=1)


def test_tensor_swapper_roundtrip(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper
    sw = AsyncTensorSwapper(str(tmp_path))
    t = torch.arange(1000, dtype=torch.float32)
    sw.swap_out("a", t)
    assert torch.equal(sw.swap_in("a")[:1000], t)
    b = torch.arange(300, dtype=torch.int16).view(torch.bfloat16)   # bf16 as its bits
    sw.swap_out("b", b)
    assert torch.equal(sw.swap_in("b")[:300].view(torch.int16), b.view(torch.int16))
    assert sw.contains("a")
    sw.remove("a")
    assert not sw.contains("a") and not (tmp_path / "a.swp").exists()


def test_param_swapper_prefetch(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import AsyncPartitionedParameterSwapper
    sw = AsyncPartitionedParameterSwapper(str(tmp_path))
    a = torch.arange(100, dtype=torch.float32)
    b = torch.arange(200, dtype=torch.float32) * 2
    sw.swap_out_and_release("layer0", a)
    sw.swap_out_and_release("layer1", b)
    sw.swapper.wait()
    sw.prefetch("layer0")
    sw.prefetch("layer1")
    assert torch.equal(sw.get("layer0"), a) and torch.equal(sw.get("layer1"), b)
    assert sw.available_keys() == ["layer0", "layer1"]
    sw.release("layer0")
    sw.release("layer1")


def test_optimizer_swapper_steps_with_cpu_adam(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import PartitionedOptimizerSwapper
    rng = np.random.default_rng(1)
    parts = {"g0": torch.from_numpy(rng.standard_normal(700).astype(np.float32)),
             "g1": torch.from_numpy(rng.standard_normal(1300).astype(np.float32))}
    grads = {k: torch.from_numpy((0.01 * rng.standard_normal(v.numel())).astype(np.float32))
             for k, v in parts.items()}
    sw = PartitionedOptimizerSwapper(str(tmp_path))
    for k, v in parts.items():
        sw.register_partition(k, v)
    opt = DeepSpeedCPUAdam(lr=1e-2)
    opt.begin_step()

    def step_fn(key, numel, states):
        opt._m[key] = states["exp_avg"][:numel]      # the state lives in the swapped buffers
        opt._v[key] = states["exp_avg_sq"][:numel]
        opt.step(key, states["master"][:numel], grads[key])

    sw.step_all(step_fn)
    for k, v in parts.items():
        ref_opt, ref = DeepSpeedCPUAdam(lr=1e-2), v.clone()
        ref_opt.begin_step()
        ref_opt.step(k, ref, grads[k])
        assert torch.equal(sw.read_master(k), ref)      # the same native update
        assert torch.equal(sw.read_state(k, "exp_avg"), ref_opt._m[k])


# ------------------------------------------------------ cpu_adam, adagrad

@pytest.mark.parametrize("adamw", [True, False])
@pytest.mark.parametrize("n", [17, 4096])
def test_adam_step_matches_reference_and_the_jax_package(adamw, n):
    rng = np.random.default_rng(0)
    p = rng.standard_normal(n).astype(np.float32)
    g = (0.01 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01, adamw_mode=adamw)
    opt, jopt = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    got, jgot = torch.from_numpy(p.copy()), p.copy()
    for _ in range(3):
        opt.begin_step()
        opt.step("w", got, torch.from_numpy(g))
        jopt.begin_step()
        jopt.step("w", jgot, g)
    # the same source: bit-equal
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(opt._m["w"].numpy(), jopt._m["w"])
    np.testing.assert_array_equal(opt._v["w"].numpy(), jopt._v["w"])
    want, m_want, _ = ref_adam(p, g, np.zeros(n, np.float32), np.zeros(n, np.float32),
                               1e-2, 0.9, 0.95, 1e-8, 0.01, adamw, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(opt._m["w"].numpy(), m_want, rtol=1e-5, atol=1e-7)


def test_adam_bf16_grads_and_copy_out_match_the_plain_twin_and_the_jax_package():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    n = 1024
    p = rng.standard_normal(n).astype(np.float32)
    g32 = torch.from_numpy((0.01 * rng.standard_normal(n)).astype(np.float32))
    g_bf16 = g32.to(torch.bfloat16)          # the device grads, as their 16-bit words
    got, out = torch.from_numpy(p.copy()), torch.empty(n, dtype=torch.bfloat16)
    opt = DeepSpeedCPUAdam(lr=1e-2)
    opt.begin_step()
    opt.step("w", got, g_bf16, param_out_bf16=out)
    jgot, jout = p.copy(), np.empty(n, np.uint16)
    jopt = JaxCPUAdam(lr=1e-2)
    jopt.begin_step()
    jopt.step("w", jgot, g_bf16.view(torch.int16).numpy().view(np.uint16), param_out_bf16=jout)
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(out.view(torch.int16).numpy().view(np.uint16), jout)
    # the plain twin in fp32 torch
    plain, m, v = torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)
    pout = torch.empty(n, dtype=torch.bfloat16)
    adam_step_plain(plain, g_bf16, m, v, lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=0.0, adamw_mode=True, step=1, param_out_bf16=pout)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
    # the copy-out is bf16(updated params), round to nearest even
    assert torch.equal(out, got.to(torch.bfloat16))
    want = np.asarray(jnp.asarray(jgot, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy(), want)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_plain_twins_match_the_native_updates(wd):
    rng = np.random.default_rng(4)
    n = 777
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    g = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    for adamw in (True, False):
        a, b = p.clone(), p.clone()
        ma, va, mb, vb = (torch.zeros(n) for _ in range(4))
        oa, ob = torch.empty(n, dtype=torch.bfloat16), torch.empty(n, dtype=torch.bfloat16)
        for step in (1, 2, 3):
            kw = dict(lr=1e-2, beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=wd,
                      adamw_mode=adamw, step=step)
            adam_step(a, g, ma, va, param_out_bf16=oa, **kw)
            adam_step_plain(b, g, mb, vb, param_out_bf16=ob, **kw)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(va, vb, rtol=1e-5, atol=1e-9)
    a, b, ha, hb = p.clone(), p.clone(), torch.zeros(n), torch.zeros(n)
    for _ in range(3):
        adagrad_step(a, g, ha, lr=1e-2, eps=1e-10, weight_decay=wd)
        adagrad_step_plain(b, g, hb, lr=1e-2, eps=1e-10, weight_decay=wd)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_adagrad_matches_reference_and_the_jax_package():
    rng = np.random.default_rng(2)
    n = 513
    p = rng.standard_normal(n).astype(np.float32)
    g = (0.1 * rng.standard_normal(n)).astype(np.float32)
    opt, jopt = DeepSpeedCPUAdagrad(lr=1e-2, eps=1e-10), JaxCPUAdagrad(lr=1e-2, eps=1e-10)
    got, jgot = torch.from_numpy(p.copy()), p.copy()
    for _ in range(2):
        opt.begin_step()
        opt.step("w", got, torch.from_numpy(g))
        jopt.begin_step()
        jopt.step("w", jgot, g)
    np.testing.assert_array_equal(got.numpy(), jgot)
    want, h = p.copy(), np.zeros(n, np.float32)
    for _ in range(2):
        h = h + g * g
        want = want - 1e-2 * g / (np.sqrt(h) + 1e-10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_state_dict_roundtrip_keeps_the_update():
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    g = torch.from_numpy((0.1 * rng.standard_normal(300)).astype(np.float32))
    a, b = DeepSpeedCPUAdam(lr=1e-2), DeepSpeedCPUAdam(lr=1e-2)
    pa, pb = p.clone(), p.clone()
    a.begin_step()
    a.step("w", pa, g)
    b.load_state_dict(a.state_dict())
    pb.copy_(pa)
    for opt, t in ((a, pa), (b, pb)):
        opt.begin_step()
        opt.step("w", t, g)
    assert torch.equal(pa, pb) and b.step_count == 2


# ------------------------------------------------------------ the build

def test_library_is_built_from_the_port_sources_with_the_jax_flags():
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libdstpu_host_")
    assert native.HOST_CSRC.name == "host" and native.HOST_CSRC.parent.name == "csrc"
    assert native.HOST_CSRC.parent.parent.name == "deepspeed_tpu_torch"
    # the JAX package's csrc/Makefile flags, and -fno-math-errno, which lets
    # the update loops vectorize and leaves their results bit-equal (the
    # cpu_adam and cpu_adagrad cases above compare the two builds)
    make = (native.HOST_CSRC.parents[2] / "csrc" / "Makefile").read_text()
    extra = [f for f in native.CXX_FLAGS + native.ARCH_FLAGS if f not in make]
    assert extra == ["-fno-math-errno"]
    for src in native.SOURCES:
        assert (native.HOST_CSRC / src).read_bytes() == \
            (native.HOST_CSRC.parents[2] / "csrc" / src).read_bytes()


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    # a $CXX that fails hands over to g++ on the PATH
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.build().exists()
    # every compiler failing raises, each attempt's output in the message
    for p in tmp_path.glob("*.so"):
        p.unlink()
    monkeypatch.setenv("CXX", "false")
    tried = []

    def refuse(cmd, **kw):
        tried.append(cmd[0])
        return subprocess.CompletedProcess(cmd, 1, "", f"{cmd[0]}: no OpenMP")

    monkeypatch.setattr(native.subprocess, "run", refuse)
    with pytest.raises(RuntimeError, match="host library build failed") as err:
        native.build()
    assert tried == [c for c in ("false", "g++", "c++", "/usr/bin/g++") for _ in range(2)]
    assert str(err.value).count("no OpenMP") == 8
    assert not list(tmp_path.glob("*.so"))
