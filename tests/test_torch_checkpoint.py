"""Engine checkpoints in the JAX package's format: the port's
``save_checkpoint`` / ``load_checkpoint`` / ``auto_resume`` against the JAX
engine's on a one-device mesh (its Pallas kernels in interpret mode), on the
tiny Llama of ``test_torch_training.py`` (2 layers, d_model 128, fp32,
``attention_backend="flash"``).

- Format: after the same 2 steps the port's ``state.npz`` holds the JAX
  engine's keys, shapes and dtypes (bf16 as raw bits under
  ``key::dt=bfloat16``), and ``meta.json`` its fields and
  ``opt_state_labels``, for every engine-built optimizer, gas 1 and 2, MoQ
  and bf16.
- Cross-load both ways: a tag one package wrote, loaded into the other, and
  the next 2 steps in both held within ``LOSS_TOL`` / ``LEAF_TOL``.
- Resume identity in the port (the engine's dataloader, ``set_dataiterator``):
  bit-equal losses; the async snapshot sees no later step; planted faults
  (no optimizer states, no fast-forward, the moments' order reversed) read
  above their limits."""

import json
import os
import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.runtime.checkpoint_engine import safe_engine as jsafe
from deepspeed_tpu_torch.checkpoint.from_jax import opt_state_to_jax, params_from_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.runtime import optimizers as popt
from deepspeed_tpu_torch.runtime.checkpoint_engine import safe_engine
from deepspeed_tpu_torch.utils import fault_injection as fi
from tests.test_torch_training import (LEAF_TOL, LLAMA, LOSS_TOL, _batches, _config,
                                       _jax_params, _leaf_errs, _port,
                                       one_device_mesh)  # noqa: F401
from tests.test_torch_training_optimizers import MOQ, OPTIMIZERS, _assert_moq_close

CASES = {
    "fusedadam_gas1": _config(gas=1),
    "fusedadam_gas2": _config(gas=2),
    "adamw": _config(optimizer={"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.01}}),
    "adam_l2": _config(optimizer={"type": "Adam", "params": {"lr": 3e-4, "weight_decay": 0.01}}),
    "lamb_moq": _config(optimizer=OPTIMIZERS["fusedlamb"], quantize_training=MOQ),
    "sgd": _config(optimizer=OPTIMIZERS["sgd"]),
    "lion": _config(optimizer=OPTIMIZERS["lion"]),
    "adagrad": _config(optimizer=OPTIMIZERS["adagrad"]),
    "fusedadam_bf16": _config(gas=1, bf16={"enabled": True}),
}


def _engines(mesh, config, seed=3):
    jmodel, jparams = _jax_params(LLAMA, seed=seed)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                             config=config, mesh=mesh)
    return jeng, _port(LLAMA, jparams, config), jparams


def _rows(config):
    return config["train_batch_size"]


def _raw_layout(tag_dir):
    """{member: (dtype, shape)} of a tag's state.npz, undecoded."""
    with np.load(os.path.join(tag_dir, "state.npz")) as z:
        return {k: (z[k].dtype.str, z[k].shape) for k in z.files}


def _meta(tag_dir):
    with open(os.path.join(tag_dir, "meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_state_npz_layout_matches_the_jax_engine(one_device_mesh, case, tmp_path):
    config = CASES[case]
    jeng, peng, _ = _engines(one_device_mesh, config)
    for batch in _batches(21, 2, _rows(config)):
        jeng.train_batch(batch)
        peng.train_batch(batch)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    peng.save_checkpoint(str(tmp_path / "port"), tag="t")
    want = _raw_layout(tmp_path / "jax" / "t")
    got = _raw_layout(tmp_path / "port" / "t")
    got.pop("__torch_rng_state__")
    assert got == want
    if case == "fusedadam_bf16":
        assert "params.embed.tokens::dt=bfloat16" in got
    if case == "fusedadam_gas2":
        assert any(k.startswith("acc_grads.") for k in got)
    jm, pm = _meta(tmp_path / "jax" / "t"), _meta(tmp_path / "port" / "t")
    assert set(pm) == set(jm)
    for key in ("opt_state_labels", "global_steps", "micro_steps", "skipped_steps",
                "data_progress", "lr_scheduler", "format", "framework_version", "tag",
                "ds_config", "client_state"):
        assert pm[key] == jm[key], key
    if "moq_state" in jm:
        assert pm["moq_state"] == jm["moq_state"]
    # the JAX reader decodes the port's tag to the JAX engine's arrays
    jflat = jsafe.read_npz(str(tmp_path / "jax" / "t" / "state.npz"))
    pflat = jsafe.read_npz(str(tmp_path / "port" / "t" / "state.npz"))
    for k in ("counters.global_steps", "scaler.loss_scale", "opt_state_flat.leaf_0"):
        assert pflat[k].dtype == jflat[k].dtype and pflat[k].shape == jflat[k].shape
    # opt_state_to_jax: the JAX engine's flattened optimizer state, in its
    # order; jax.tree.unflatten under the JAX treedef holds the same moments
    # (fp32 runs: bf16 gradients summed in other orders give other moments)
    flat = opt_state_to_jax(peng._optimizer_name, peng.state.opt_state,
                            config["optimizer"]["params"])
    jleaves, treedef = jax.tree_util.tree_flatten_with_path(jeng.state.opt_state)
    assert list(flat) == [jax.tree_util.keystr(p) for p, _ in jleaves]
    rebuilt = jax.tree.unflatten(treedef, list(flat.values()))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(jeng.state.opt_state)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if "bf16" not in config:
            assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max() + 1e-12


def _continue_both(jeng, peng, batches):
    for step, batch in enumerate(batches):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)


@pytest.mark.parametrize("case", ["fusedadam_gas1", "fusedadam_gas2", "lamb_moq"])
def test_a_jax_tag_loads_into_the_port(one_device_mesh, case, tmp_path):
    """The JAX engine trains 2 steps and saves; a port engine built from
    other weights loads the tag; the next 2 steps of both agree."""
    config = CASES[case]
    jeng, _, _ = _engines(one_device_mesh, config, seed=3)
    _, jother = _jax_params(LLAMA, seed=11)
    peng = _port(LLAMA, jother, config)
    first, after = _batches(23, 2, _rows(config)), _batches(24, 2, _rows(config))
    for batch in first:
        jeng.train_batch(batch)
    jeng.save_checkpoint(str(tmp_path), tag="j")
    path, _ = peng.load_checkpoint(str(tmp_path), tag="j")
    assert path.endswith("j") and peng.global_steps == 2
    assert max(jax.tree.leaves(_leaf_errs(peng.module.config, peng, jeng.state.params))) == 0.0
    _continue_both(jeng, peng, after)
    if case == "lamb_moq":
        assert peng.quantizer.state_dict() == jeng.quantizer.state_dict()
        _assert_moq_close(peng, jeng, 8)
    else:
        assert max(jax.tree.leaves(_leaf_errs(peng.module.config, peng,
                                              jeng.state.params))) <= LEAF_TOL


@pytest.mark.parametrize("case", ["fusedadam_gas1", "fusedadam_gas2", "lamb_moq"])
def test_a_port_tag_loads_into_the_jax_engine(one_device_mesh, case, tmp_path):
    """The port trains 2 steps and saves; a JAX engine built from other
    weights loads the tag; the next 2 steps of both agree."""
    config = CASES[case]
    _, peng, _ = _engines(one_device_mesh, config, seed=3)
    jmodel, jother = _jax_params(LLAMA, seed=11)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jother,
                                             config=config, mesh=one_device_mesh)
    first, after = _batches(25, 2, _rows(config)), _batches(26, 2, _rows(config))
    for batch in first:
        peng.train_batch(batch)
    peng.save_checkpoint(str(tmp_path), tag="p")
    path, _ = jeng.load_checkpoint(str(tmp_path), tag="p")
    assert path.endswith("p") and int(jeng.state.global_steps) == 2
    assert max(jax.tree.leaves(_leaf_errs(peng.module.config, peng, jeng.state.params))) == 0.0
    _continue_both(jeng, peng, after)
    if case == "lamb_moq":
        assert peng.quantizer.state_dict() == jeng.quantizer.state_dict()
        _assert_moq_close(peng, jeng, 8)
    else:
        assert max(jax.tree.leaves(_leaf_errs(peng.module.config, peng,
                                              jeng.state.params))) <= LEAF_TOL


def test_moments_in_reversed_order_read_above_the_limit(one_device_mesh, monkeypatch, tmp_path):
    """Planted: the port writes nu before mu in opt_state_flat. The JAX
    engine loads it without complaint (the shapes agree), and its next
    steps leave LEAF_TOL far behind (or turn NaN: a negative first moment
    read as the second, under a square root, which fails the check too)."""
    config = CASES["fusedadam_gas1"]
    _, peng, _ = _engines(one_device_mesh, config)
    jmodel, jother = _jax_params(LLAMA, seed=11)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jother,
                                             config=config, mesh=one_device_mesh)
    for batch in _batches(27, 2, 2):
        peng.train_batch(batch)
    from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ckpt_engine
    real = popt.jax_state_layout
    monkeypatch.setattr(ckpt_engine, "jax_state_layout",
                        lambda *a: (real(*a)[0], ("count", "nu", "mu")))
    peng.save_checkpoint(str(tmp_path), tag="p")
    monkeypatch.undo()
    jeng.load_checkpoint(str(tmp_path), tag="p")
    for batch in _batches(28, 2, 2):
        jeng.train_batch(batch)
        peng.train_batch(batch)
    worst = max(jax.tree.leaves(_leaf_errs(peng.module.config, peng, jeng.state.params)))
    assert not worst <= 10 * LEAF_TOL, worst


# ----------------------------------------------------------------------- #
# resume in the port

def _dataset(n=24, S=64, seed=5):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (S,)).astype(np.int32)} for _ in range(n)]


def _train_engine(jparams, config, data=None):
    model = CausalLM(TransformerConfig(**LLAMA))
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(model.config, jparams), config=config,
        training_data=data, device="cpu")
    return engine, loader


def _masters(engine):
    return {n: p.detach().clone() for n, p in engine.state.params.named_parameters()}


def test_resume_from_the_engines_dataloader_is_bit_equal(tmp_path):
    """6 steps straight against 3, save, a new engine from other weights,
    auto_resume, 3 more: the losses of steps 4-6 and every leaf after step 6
    bit-equal (24 samples at 4 a batch: the run rolls into epoch 2)."""
    config, data = _config(), _dataset()
    _, jparams = _jax_params(LLAMA, seed=3)
    _, other = _jax_params(LLAMA, seed=12)
    straight, loader = _train_engine(jparams, config, data)
    assert loader is straight.training_dataloader and len(loader) == 12
    want = [float(straight.train_batch()) for _ in range(6)]
    a, _ = _train_engine(jparams, config, data)
    for _ in range(3):
        a.train_batch()
    a.save_checkpoint(str(tmp_path))
    a.destroy()
    b, _ = _train_engine(other, config, data)
    path, _ = b.auto_resume(str(tmp_path))
    assert path.endswith("global_step3") and b._data_progress["iterations"] == 3
    got = [float(b.train_batch()) for _ in range(3)]
    assert got == want[3:], (got, want)
    mine, theirs = _masters(b), _masters(straight)
    assert all(torch.equal(mine[n], theirs[n]) for n in mine)


def test_resume_through_set_dataiterator_is_bit_equal(tmp_path):
    config = _config()
    _, jparams = _jax_params(LLAMA, seed=3)

    def stream():
        for i in range(100):
            yield {"input_ids": np.random.default_rng(300 + i).integers(0, 256, (2, 64))}

    straight, _ = _train_engine(jparams, config)
    straight.set_dataiterator(stream())
    want = [float(straight.train_batch()) for _ in range(4)]
    a, _ = _train_engine(jparams, config)
    a.set_dataiterator(stream())
    a.train_batch()
    a.train_batch()
    a.save_checkpoint(str(tmp_path))
    b, _ = _train_engine(_jax_params(LLAMA, seed=12)[1], config)
    b.set_dataiterator(stream())               # a fresh stream, before auto_resume
    b.auto_resume(str(tmp_path))
    assert [float(b.train_batch()) for _ in range(2)] == want[2:]


class _HeldWrites(fi.FaultInjector):
    """Every write waits until the test releases it."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()

    def on_write(self, path, size):
        assert self.release.wait(timeout=60)
        return super().on_write(path, size)


def test_async_snapshot_does_not_see_the_next_step(tmp_path):
    """Save async with the writer held at its first write until the next
    step has updated the tensors in place: the tag holds the pre-step
    values, bit for bit."""
    config = _config(gas=1)
    _, jparams = _jax_params(LLAMA, seed=3)
    engine, _ = _train_engine(jparams, config)
    batches = _batches(29, 2, 2)
    engine.train_batch(batches[0])
    before = {n: p.detach().clone() for n, p in engine.state.params.named_parameters()}
    mu_before = {n: m.clone() for n, m in engine.state.opt_state.mu.items()}
    gate = _HeldWrites()
    with fi.inject(gate):
        engine.save_checkpoint(str(tmp_path), tag="a", asynchronous=True)
        engine.train_batch(batches[1])
        assert engine._ckpt_writer.queue_depth == 1        # still persisting
        gate.release.set()
        engine.flush_checkpoints()
    flat = safe_engine.read_npz(str(tmp_path / "a" / "state.npz"))
    assert int(flat["counters.global_steps"]) == 1
    wq = torch.stack([before[f"layers.{i}.attn.wq"] for i in range(2)])
    assert torch.equal(torch.from_numpy(flat["params.layers.attn.wq"]), wq)
    assert torch.equal(torch.from_numpy(flat["params.embed.tokens"]), before["embed.tokens"])
    labels = _meta(tmp_path / "a")["opt_state_labels"]
    i = next(i for i, lab in enumerate(labels) if lab["path"] == ".mu['embed']['tokens']")
    assert torch.equal(torch.from_numpy(flat[f"opt_state_flat.leaf_{i}"]),
                       mu_before["embed.tokens"])
    assert not torch.equal(engine.state.opt_state.mu["embed.tokens"], mu_before["embed.tokens"])


@pytest.mark.parametrize("fault", ["no_optimizer_states", "no_fast_forward"])
def test_planted_resume_faults_read_above_the_limit(fault, tmp_path):
    """The resume check is bit-equality. A resume that leaves the optimizer
    state out, or that skips the data fast-forward (so batches 1-3 replay),
    misses the uninterrupted losses of steps 4-6 by more than LOSS_TOL (the
    cross-package limit; without the optimizer state, step 4's loss is still
    exact: only the updates after it differ)."""
    config, data = _config(), _dataset()
    _, jparams = _jax_params(LLAMA, seed=3)
    straight, _ = _train_engine(jparams, config, data)
    want = [float(straight.train_batch()) for _ in range(6)]
    a, _ = _train_engine(jparams, config, data)
    for _ in range(3):
        a.train_batch()
    a.save_checkpoint(str(tmp_path))
    b, _ = _train_engine(jparams, config, data)
    if fault == "no_optimizer_states":
        b.load_checkpoint(str(tmp_path), load_optimizer_states=False, load_data_progress=True)
    else:
        b.load_checkpoint(str(tmp_path))
    got = [float(b.train_batch()) for _ in range(3)]
    worst = max(abs(g - w) / abs(w) for g, w in zip(got, want[3:]))
    assert worst > LOSS_TOL, (got, want[3:])


def test_jax_tag_warns_that_the_dropout_stream_stays(one_device_mesh, tmp_path, caplog):
    """A tag the JAX package wrote has no torch RNG state: the port keeps
    its own stream and says so."""
    config = CASES["fusedadam_gas1"]
    jeng, peng, _ = _engines(one_device_mesh, config)
    jeng.save_checkpoint(str(tmp_path), tag="j")
    state = peng._rng.get_state().clone()
    from deepspeed_tpu_torch.utils.logging import logger
    logger.propagate = True
    try:
        with caplog.at_level("WARNING"):
            peng.load_checkpoint(str(tmp_path), tag="j")
    finally:
        logger.propagate = False
    assert "dropout stream" in caplog.text
    assert torch.equal(peng._rng.get_state(), state)
    with zipfile.ZipFile(tmp_path / "j" / "state.npz") as z:
        assert "__torch_rng_state__.npy" not in z.namelist()
