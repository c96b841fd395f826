"""ZeRO-Offload in the port (``zero_optimization.offload_optimizer`` on
"cpu" or "nvme": fp32 masters and moments on the host, stepped by the host
library's cpu_adam / cpu_adagrad, the card keeping the compute params and
the accumulation buffers) on a tiny Llama, the counterparts of
``tests/unit/test_offload.py``: against the port's device optimizer at the
JAX file's ``rtol=2e-4, atol=2e-5`` after 5 steps; against the JAX
package's offload engine on a one-device mesh (its Pallas flash kernels in
interpret mode) at the same tolerance; NVMe; checkpoint round trips in
both modes; a port tag loading in the JAX engine and a JAX tag in the port
(``offload_state_p0.npz`` in the JAX layout); the client optimizer
refused. Also the trio's ``step()``, ``load_module_state_dict`` refreshing
the host masters, and the config's offload sections. The comparisons run
at lr 1e-4: Adam's normalised update turns the reduction-order noise of a
near-zero gradient element into a difference of order lr, which at 1e-2
(the descent tests') exceeds ``atol`` at one element in 8192."""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.config.core import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

RTOL, ATOL = 2e-4, 2e-5
LLAMA = dict(vocab_size=128, max_seq=32, n_layer=2, n_head=2, n_kv_head=1, d_model=64, d_ff=128,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             norm_eps=1e-6, attention_backend="flash")


def _config(offload=None, gas=1, micro=2, opt="AdamW", bf16=False, lr=1e-2):
    cfg = {"train_batch_size": gas * micro, "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": opt, "params": {"lr": lr, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "fused_cross_entropy": "off",
           "zero_optimization": {"stage": 1}}
    if opt == "Adagrad":
        cfg["optimizer"]["params"] = {"lr": lr}
    if offload:
        cfg["zero_optimization"]["offload_optimizer"] = offload
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def _batch(cfg, seed):
    r = np.random.default_rng(seed)
    return {"input_ids": r.integers(0, 128, size=(cfg["train_batch_size"], 32)).astype(np.int32)}


@pytest.fixture(scope="module")
def jparams():
    cfg = JT.TransformerConfig(**LLAMA)
    return JaxCausalLM(cfg), jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(3)))


@pytest.fixture(scope="module")
def one_device_mesh():
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def _port(jparams, config):
    model = CausalLM(TransformerConfig(**LLAMA))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(model.config, jparams[1]), config=config,
        device="cpu")[0]


def _jax(jparams, config, mesh):
    return deepspeed_tpu.initialize(model=jparams[0], model_parameters=jparams[1],
                                    config=config, mesh=mesh)[0]


def _leaves(engine):
    return jax.tree.leaves(params_to_jax(engine.module.config, engine.state.params))


def _nvme(tmp_path, name="swap"):
    return {"device": "nvme", "nvme_path": str(tmp_path / name)}


@pytest.mark.parametrize("gas", [1, 2])
def test_cpu_offload_matches_device_optimizer(jparams, gas):
    dev = _port(jparams, _config(gas=gas, lr=1e-4))
    off = _port(jparams, _config({"device": "cpu"}, gas=gas, lr=1e-4))
    for step in range(5):
        b = _batch(_config(gas=gas), step)
        dev.train_batch(b)
        off.train_batch(b)
    for a, b in zip(_leaves(dev), _leaves(off)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert off.global_steps == 5 and off._offload.opt.step_count == 5


@pytest.mark.parametrize("case", ["adamw-cpu", "adamw-nvme", "adagrad-cpu"])
def test_offload_matches_the_jax_offload_engine(jparams, one_device_mesh, case, tmp_path):
    opt, device = case.split("-")
    off = {"device": "cpu"} if device == "cpu" else _nvme(tmp_path, "p")
    joff = {"device": "cpu"} if device == "cpu" else _nvme(tmp_path, "j")
    cfg = _config(off, gas=2, micro=4, opt={"adamw": "AdamW", "adagrad": "Adagrad"}[opt], lr=1e-4)
    peng = _port(jparams, cfg)
    jeng = _jax(jparams, _config(joff, gas=2, micro=4, opt=cfg["optimizer"]["type"], lr=1e-4),
                one_device_mesh)
    for step in range(5):
        b = _batch(cfg, step)
        want, got = float(jeng.train_batch(b)), float(peng.train_batch(b))
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jeng.state.params))
    for a, b in zip(want, _leaves(peng)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    # the host state is the JAX layout, key for key and shape for shape
    jsd, psd = jeng._offload.state_dict(), peng._offload.state_dict()
    assert set(jsd) == set(psd) and jsd["step"] == psd["step"] == 5
    for group in ("masters", "exp_avg_sq"):
        assert list(jsd[group]) == list(psd[group])
        for k, v in jsd[group].items():
            assert psd[group][k].shape == v.shape
            np.testing.assert_allclose(psd[group][k], v, rtol=RTOL, atol=ATOL)


def test_cpu_offload_bf16_loss_descends_without_device_optimizer_state(jparams):
    e = _port(jparams, _config({"device": "cpu"}, gas=2, bf16=True))
    b = _batch(_config(gas=2), 0)
    losses = [float(e.train_batch(b)) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.7
    assert e.global_steps == 12
    # the card keeps the bf16 params and the fp32 accumulation buffers only
    assert e.state.master is None and e.state.opt_state is None
    assert all(g.dtype == torch.float32 for g in e.state.acc_grads.values())
    assert all(p.dtype == torch.bfloat16 for p in e.state.params.parameters())
    # the params are the bf16 copy-out of the host masters
    for key, names in e._offload_groups.items():
        named = e._param_dict(e.state.params)
        for n, m in zip(names, e._offload.layer_views(key)):
            assert torch.equal(named[n], m.to(torch.bfloat16))


def test_nvme_offload_keeps_its_state_on_disk(jparams, tmp_path):
    e = _port(jparams, _config(_nvme(tmp_path)))
    b = _batch(_config(), 0)
    losses = [float(e.train_batch(b)) for _ in range(10)]
    assert losses[-1] < losses[0] * 0.7
    swp = [f for f in os.listdir(tmp_path / "swap") if f.endswith(".swp")]
    assert len(swp) == 3 * len(e._offload.order)
    assert e._offload._masters == {}


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_checkpoint_roundtrip(jparams, device, tmp_path):
    off = {"device": "cpu"} if device == "cpu" else _nvme(tmp_path, "a")
    e = _port(jparams, _config(off, bf16=True))
    for s in range(3):
        e.train_batch(_batch(_config(), s))
    before = e._offload.state_dict()
    before = {g: ({k: np.array(v) for k, v in before[g].items()} if isinstance(before[g], dict)
                  else before[g]) for g in before}
    assert any(np.abs(v).max() > 0 for v in before["exp_avg"].values())
    e.save_checkpoint(str(tmp_path / "ckpt"))
    assert os.path.exists(tmp_path / "ckpt" / "global_step3" / "offload_state_p0.npz")
    off2 = {"device": "cpu"} if device == "cpu" else _nvme(tmp_path, "b")
    e2 = _port(jparams, _config(off2, bf16=True))
    e2.load_checkpoint(str(tmp_path / "ckpt"))
    after = e2._offload.state_dict()
    assert e2.global_steps == 3 and after["step"] == 3
    for g in ("masters", "exp_avg", "exp_avg_sq"):
        for k, v in before[g].items():
            np.testing.assert_array_equal(after[g][k], v)
    b = _batch(_config(), 99)
    assert float(e.train_batch(b)) == float(e2.train_batch(b))
    for a, b_ in zip(_leaves(e), _leaves(e2)):
        np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_offload_tags_cross_load(jparams, one_device_mesh, direction, tmp_path):
    cfg = _config({"device": "cpu"}, gas=2)
    src_port = direction == "port_to_jax"
    src = _port(jparams, cfg) if src_port else _jax(jparams, cfg, one_device_mesh)
    for s in range(2):
        src.train_batch(_batch(cfg, s))
    src.save_checkpoint(str(tmp_path / "ckpt"))
    dst = _jax(jparams, cfg, one_device_mesh) if src_port else _port(jparams, cfg)
    dst.load_checkpoint(str(tmp_path / "ckpt"))
    assert int(dst.global_steps) == 2
    ssd, dsd = src._offload.state_dict(), dst._offload.state_dict()
    assert int(dsd["step"]) == 2
    for g in ("masters", "exp_avg", "exp_avg_sq"):
        assert list(ssd[g]) == list(dsd[g])
        for k in ssd[g]:
            np.testing.assert_array_equal(np.asarray(dsd[g][k]), np.asarray(ssd[g][k]))
    b = _batch(cfg, 7)
    want, got = float(src.train_batch(b)), float(dst.train_batch(b))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_offload_rejects_client_optimizer(jparams):
    model = CausalLM(TransformerConfig(**LLAMA))
    with pytest.raises(ValueError, match="offload_optimizer"):
        deepspeed_tpu_torch.initialize(
            model=model, model_parameters=params_from_jax(model.config, jparams[1]),
            optimizer=lambda ps: torch.optim.AdamW(ps, lr=1e-4),
            config=_config({"device": "cpu"}), device="cpu")


def test_trio_step_matches_train_batch_under_offload(jparams):
    cfg = _config({"device": "cpu"}, gas=2)
    a, b = _port(jparams, cfg), _port(jparams, cfg)
    for s in range(3):
        batch = _batch(cfg, s)
        a.train_batch(batch)
        for i in range(2):
            b.backward(b({"input_ids": batch["input_ids"][2 * i:2 * i + 2]}))
            b.step()
    assert a.global_steps == b.global_steps == 3
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_load_module_state_dict_refreshes_the_host_masters(jparams):
    e = _port(jparams, _config({"device": "cpu"}, bf16=True))
    e.train_batch(_batch(_config(), 0))
    neg = e.state.params.map(lambda t: -t.detach())
    e.load_module_state_dict(neg)
    named = dict(neg.named_parameters())
    for key, names in e._offload_groups.items():
        for n, m in zip(names, e._offload.layer_views(key)):
            assert torch.equal(m, named[n].float())
    # the next step starts from the loaded weights, not the old masters
    e.train_batch(_batch(_config(), 1))
    for key, names in e._offload_groups.items():
        for n, m in zip(names, e._offload.layer_views(key)):
            assert float((m - named[n].float()).abs().max()) < 0.05


def test_config_takes_the_offload_sections():
    cfg = DeepSpeedConfig(_config({"device": "nvme", "nvme_path": "/x"}))
    assert cfg.offload_optimizer_device == "nvme" and cfg.offload_optimizer_nvme_path == "/x"
    assert DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}).offload_param_device == "cpu"
    assert DeepSpeedConfig({"train_batch_size": 2, "zero_optimization": {
        "cpu_offload": True}}).offload_optimizer_device == "cpu"
    with pytest.raises(DeepSpeedConfigError, match="device"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "zero_optimization": {"offload_optimizer": {"device": "gpu"}}})
