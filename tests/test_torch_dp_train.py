"""Data-parallel training at ZeRO stage 0 as a whole, on the CPU:
``python -m deepspeed_tpu_torch.cli run`` with ``DS_NUM_CHIPS=2`` spawns two
gloo ranks (``tests/torch_dp_rank.py``, no JAX) that train the tiny Llama
of ``tests/test_torch_training.py`` for 3 steps, micro 2 x gas 2 x dp 2,
AdamW, each on its block of the same global batches. The reference is the
JAX engine on a ``{"dp": 2}`` mesh of 2 CPU devices (its Pallas flash
kernels in interpret mode) on the same global batches, from the same
weights carried by ``checkpoint/from_jax.py``: per-step loss within
``LOSS_TOL`` and every leaf within ``LEAF_TOL`` (the key-bias rule of
``test_engine_matches_jax_engine``), both ranks' params bit-equal. Also:
the engine's dataloader gives the same steps bit for bit; a rank-0
checkpoint at world 2 loads back on both ranks bit-equal; an fp16 overflow
planted on rank 1 alone makes both ranks skip the step, the scaler
following the JAX package's transition; ZeRO stage 1 at world 2 trains to
the same tolerances."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm.mesh import build_mesh as jax_build_mesh
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.runtime import loss_scaler as jls
from tests import torch_dp_rank as R
from tests.test_torch_training import LEAF_TOL, LOSS_TOL
from tests.torch_launch_util import ROOT, free_port, rank_env, run_launch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def _jax_params(seed=3):
    cfg = JT.TransformerConfig(**R.LLAMA)
    return JaxCausalLM(cfg), jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(seed)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' records, launched once for the module."""
    out = tmp_path_factory.mktemp("dp_train")
    _, jparams = _jax_params()
    np.savez(out / "weights.npz", **R.flatten(jparams))
    run_launch([sys.executable, "-m", "deepspeed_tpu_torch.cli", "run",
                f"--master_port={free_port()}", f"--enable_each_rank_log={out / 'logs'}",
                str(ROOT / "tests" / "torch_dp_rank.py"), "--weights", str(out / "weights.npz"),
                "--out", str(out)], out / "logs", timeout=180, env=rank_env(DS_NUM_CHIPS="2"))
    ranks = []
    for r in range(R.DP):
        rec = json.loads((out / f"rank_{r}.json").read_text())
        with np.load(out / f"rank_{r}.npz") as z:
            rec["params"] = dict(z)
        with np.load(out / f"fp16_rank_{r}.npz") as z:
            rec["fp16_params"] = dict(z)
        with np.load(out / f"stage1_rank_{r}.npz") as z:
            rec["stage1_params"] = dict(z)
        ranks.append(rec)
    return ranks


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine at dp 2 on the same global batches: losses, lrs and
    the final params."""
    saved = jcomm._mesh
    mesh = jax_build_mesh({"dp": R.DP}, devices=jax.devices()[:R.DP])
    try:
        jmodel, jparams = _jax_params()
        eng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                                config=R.CONFIG, mesh=mesh)
        losses, lrs = [], []
        for b in R.batches():
            losses.append(float(eng.train_batch(b)))
            lrs.append(float(eng.get_lr()[0]))
        params = R.flatten(jax.tree.map(np.asarray, eng.state.params))
    finally:
        jcomm.set_mesh(saved)
    return losses, lrs, params


def test_ranks_are_two_gloo_data_parallel_ranks(run):
    for r, rec in enumerate(run):
        assert (rec["rank"], rec["world"], rec["backend"]) == (r, R.DP, "gloo")
        assert (rec["dp_rank"], rec["dp_world"], rec["flat"]) == (r, R.DP, True)


def test_losses_match_jax_engine_at_dp2(run, jax_run):
    want, lrs, _ = jax_run
    for rec in run:
        assert len(rec["losses"]) == R.STEPS
        for step, (got, w) in enumerate(zip(rec["losses"], want)):
            assert abs(got - w) <= LOSS_TOL * abs(w), (rec["rank"], step, got, w)
        assert rec["lr"] == pytest.approx([lrs[-1]], rel=1e-6)
    assert run[0]["losses"] == run[1]["losses"]       # the dp mean, on every rank


def test_params_match_jax_engine_at_dp2(run, jax_run):
    _, lrs, want = jax_run
    got = run[0]["params"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(run[1]["params"][k], got[k], err_msg=k)
        err = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
        if k.endswith("attn/bk"):
            # the key bias's exact gradient is zero: Adam moves rounding
            # noise there by up to lr a step, in each package's own direction
            assert np.abs(got[k] - want[k]).max() <= 2 * sum(lrs), k
        else:
            assert err <= LEAF_TOL, (k, err)


def test_engine_dataloader_gives_each_rank_its_block(run):
    for rec in run:
        assert rec["loader_losses"] == rec["losses"]
        assert rec["loader_state_equal"]


def test_rank0_checkpoint_loads_back_on_both_ranks(run):
    for rec in run:
        assert rec["ckpt_state_equal"]
        assert "latest" in rec["ckpt_files"]


def test_fp16_overflow_on_one_rank_skips_on_both(run):
    """Rank 1's rows overflow at one step: both ranks skip it (params
    unchanged), the scaler follows the JAX package's pure transition over
    the same overflow sequence, and the ranks stay bit-equal."""
    jstate = jls.make_loss_scale_state(init_scale=2.0 ** R.FP16["initial_scale_power"],
                                       scale_window=R.FP16["loss_scale_window"], min_scale=1.0,
                                       delayed_shift=R.FP16["hysteresis"])
    for step in range(R.STEPS):
        applied = step != R.OVERFLOW_STEP
        jstate = jls.update(jstate, jnp.asarray(not applied))
        for rec in run:
            s = rec["fp16"][step]
            assert (s["applied"], s["unchanged"]) == (applied, not applied), (rec["rank"], step)
            assert (s["scale"], s["good"], s["hyst"]) == (
                float(jstate.loss_scale), int(jstate.good_steps), int(jstate.hysteresis))
    for rec in run:
        assert rec["fp16_skipped"] == 1
    for k, v in run[0]["fp16_params"].items():
        np.testing.assert_array_equal(run[1]["fp16_params"][k], v, err_msg=k)


def test_stage1_at_world2_names_its_item(run, jax_run):
    """ZeRO stage 1 at world 2 trains (it was refused before the ZeRO
    slice): its losses and params within the tolerances of the JAX engine's
    (ZeRO only partitions the update), both ranks bit-equal."""
    want, lrs, params = jax_run
    for rec in run:
        for got, w in zip(rec["stage1"], want):
            assert abs(got - w) <= LOSS_TOL * abs(w), (rec["rank"], rec["stage1"], want)
    p0, p1 = run[0]["stage1_params"], run[1]["stage1_params"]
    for k in params:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        if not k.endswith("attn/bk"):
            assert float(np.abs(p0[k] - params[k]).max() / np.abs(params[k]).max()) <= LEAF_TOL
