"""ZeRO stage 3 over four gloo ranks as ``{"dp": 2, "fsdp": 2}``, and the
elastic checkpoint, against the JAX package (``tests/torch_zero_rank.py``
modes ``elastic_save`` and ``fsdp``; no JAX in the ranks):

- stage 3 on dp 2 x fsdp 2 (micro 1 x gas 2, the same 8-row global batches
  as ``tests/test_torch_zero.py``): per-step loss within ``LOSS_TOL`` and
  every leaf within ``LEAF_TOL`` of the JAX engine on the same mesh of 4
  CPU devices; the four ranks' gathered params bit-equal; each rank's
  optimizer state and gradients a quarter of the whole, plus padding;
- the elastic checkpoint (the contract of JAX
  ``tests/unit/test_engine.py:252-275``): a tag saved at stage 2 on two
  ranks loads at stage 3 on dp 2 x fsdp 2, its params bit-equal to the
  saved ones, ``global_steps`` carried over, the next loss within
  ``LOSS_TOL`` of the source's next loss;
- the JAX engine loads the tag the ZeRO ranks wrote;
- ``partition_axis`` "fsdp" on a dp 2 x fsdp 2 mesh refused, naming its
  item."""

import json
import math

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm.mesh import build_mesh as jax_build_mesh
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from tests import torch_dp_rank as R
from tests import torch_zero_rank as Z
from tests.test_torch_training import LEAF_TOL, LOSS_TOL
from tests.torch_launch_util import ROOT, launch, rank_env

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

WORLD = 4


def _jax_params(seed=3):
    cfg = JT.TransformerConfig(**R.LLAMA)
    return JaxCausalLM(cfg), jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(seed)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The elastic source's two ranks, then the four dp x fsdp ranks."""
    out = tmp_path_factory.mktemp("zero_fsdp")
    _, jparams = _jax_params()
    np.savez(out / "weights.npz", **R.flatten(jparams))
    common = ["--weights", str(out / "weights.npz"), "--out", str(out), "--ckpt",
              str(out / "ckpt")]
    launch(ROOT / "tests" / "torch_zero_rank.py", 2, ["--mode", "elastic_save", *common],
           out / "logs_src", timeout=180, env=rank_env())
    launch(ROOT / "tests" / "torch_zero_rank.py", WORLD, ["--mode", "fsdp", *common],
           out / "logs", timeout=240, env=rank_env())
    rec = {"ckpt": str(out / "ckpt"),
           "src": [json.loads((out / f"elastic_save_rank_{r}.json").read_text())
                   for r in range(2)],
           "ranks": [json.loads((out / f"fsdp_rank_{r}.json").read_text())
                     for r in range(WORLD)]}
    for tag, mode, n in (("saved", "elastic_save", 2), ("stage3", "fsdp", WORLD),
                         ("loaded", "fsdp", WORLD)):
        rec[tag] = []
        for r in range(n):
            with np.load(out / f"{mode}_{tag}_rank_{r}.npz") as z:
                rec[tag].append(dict(z))
    return rec


@pytest.fixture(scope="module")
def jax_run():
    saved = jcomm._mesh
    mesh = jax_build_mesh(Z.FSDP_MESH, devices=jax.devices()[:WORLD])
    try:
        jmodel, jparams = _jax_params()
        config = {**Z.zero_config(3), "mesh": Z.FSDP_MESH, **Z.FSDP_BATCH}
        eng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                                config=config, mesh=mesh)
        losses, lrs = [], []
        for b in R.batches():
            losses.append(float(eng.train_batch(b)))
            lrs.append(float(eng.get_lr()[0]))
        return losses, lrs, R.flatten(jax.tree.map(np.asarray, eng.state.params))
    finally:
        jcomm.set_mesh(saved)


def test_stage3_over_dp_and_fsdp_matches_jax(run, jax_run):
    want_losses, lrs, want = jax_run
    for r, rec in enumerate(run["ranks"]):
        st = rec["stage3"]
        assert st["axes"] == ["dp", "fsdp"] and st["dp_rank"] == r
        for g, w in zip(st["losses"], want_losses):
            assert abs(g - w) <= LOSS_TOL * abs(w), (r, st["losses"], want_losses)
    got = run["stage3"][0]
    for other in run["stage3"][1:]:
        for k in got:
            np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    for k in want:
        if k.endswith("attn/bk"):
            # the key bias's exact gradient is zero (see test_torch_dp_train)
            assert np.abs(got[k] - want[k]).max() <= 2 * sum(lrs), k
        else:
            err = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            assert err <= LEAF_TOL, (k, err)


def test_describe_names_both_axes(run):
    from jax.sharding import Mesh

    from deepspeed_tpu.runtime.zero.config import ZeroConfig as JaxZeroConfig
    from deepspeed_tpu.runtime.zero.partition import ZeroShardingRules as JaxRules
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "fsdp"))
    want = JaxRules(mesh, JaxZeroConfig(stage=3)).describe()
    assert {rec["stage3"]["describe"] for rec in run["ranks"]} == {want}


def test_each_of_four_ranks_holds_a_quarter(run):
    """fp32 Adam: the moments' whole is 8 bytes a parameter; each rank
    holds at most a quarter of it plus the units' alignment and padding,
    and a quarter of the padded gradient buffer; the compute params too,
    but for the units under the persistence threshold (1e5 elements), which
    every rank holds whole."""
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    from deepspeed_tpu_torch.runtime.zero.partition import build_units
    model = CausalLM(TransformerConfig(**R.LLAMA))
    named = model.init_params(torch.Generator().manual_seed(0)).named_parameters()
    units = build_units([(n, p.shape) for n, p in named], WORLD)
    numel = sum(u.numel for u in units)
    pad = sum(u.padded - u.numel for u in units)
    for rec in run["ranks"]:
        held = rec["stage3"]["held"]
        assert held["optimizer"] <= math.ceil(8 * numel / WORLD) + 8 * pad
        assert held["grads"] == 4 * sum(u.block for u in units)
        assert held["params"] == held["grads"] + 4 * sum(u.padded - u.block for u in units
                                                         if u.numel < 100_000)
        assert held["grads"] <= math.ceil(4 * numel / WORLD) + 4 * pad


def test_elastic_checkpoint_stage2_world2_to_stage3_dp2_fsdp2(run):
    saved = run["saved"][0]
    for r in range(2):
        for k in saved:
            np.testing.assert_array_equal(run["saved"][r][k], saved[k], err_msg=k)
    for r, rec in enumerate(run["ranks"]):
        el = rec["elastic"]
        assert el["path"] is not None and el["global_steps"] == run["src"][0]["global_steps"] == 3
        loaded = run["loaded"][r]
        assert loaded.keys() == saved.keys()
        for k in saved:
            np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
        want = run["src"][0]["next_loss"]
        assert abs(el["next_loss"] - want) <= LOSS_TOL * abs(want), (el["next_loss"], want)


def test_the_jax_engine_reads_the_partitioned_save(run):
    """The tag that two ZeRO-2 ranks gathered and rank 0 wrote is the JAX
    package's format: the JAX engine at stage 2 on dp 2 loads it, its
    params bit-equal to the saved ones and its step count carried."""
    saved = jcomm._mesh
    mesh = jax_build_mesh({"dp": 2}, devices=jax.devices()[:2])
    try:
        jmodel, jparams = _jax_params(seed=11)
        eng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                                config=Z.zero_config(2), mesh=mesh)
        path, _ = eng.load_checkpoint(run["ckpt"], tag="elastic")
        got = R.flatten(jax.tree.map(np.asarray, eng.state.params))
        steps = eng.global_steps
    finally:
        jcomm.set_mesh(saved)
    assert path is not None and steps == 3
    for k, v in run["saved"][0].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_hybrid_partition_axis_is_refused(run):
    for rec in run["ranks"]:
        assert "queue 1: hybrid ZeRO partitioning" in rec["refused"]["hybrid"]
