"""ZeRO stages 1-3 over two gloo ranks, against the JAX engine at the same
stage on a ``{"dp": 2}`` mesh of 2 CPU devices (its Pallas flash kernels in
interpret mode), from the same weights carried by ``checkpoint/from_jax.py``,
on the same global batches: the tiny Llama of ``tests/test_torch_dp_train.py``,
micro 2 x gas 2 x dp 2, AdamW, 3 steps, fp32 (bf16 rounds differently in
the two packages by more than ``LEAF_TOL``; the card holds bf16 at stages
1-3 bit-equal to stage 0, ``chip_smoke.py`` phase ``zero``). Per-step loss
within ``LOSS_TOL`` and every leaf within ``LEAF_TOL`` (the key-bias rule of
``test_engine_matches_jax_engine``); both ranks' gathered params bit-equal.
Also: what each rank holds, LAMB at stage 2 (every group's trust ratio
against the JAX state's ``||p|| / ||u||``, with a JAX leaf split across the
ranks; left without the cross-rank sum of its partials it reads above the
limit), SGD, Lion and Adagrad on the partitions, LAMB with MoQ at stage 2,
bf16 at stages 2 and 3 against bf16 stage 0, fp16 with an overflow on one
rank at stage 2, the health sentinels reduced over the ranks, a callable
client optimizer on the partitions, ``save_16bit_model`` under ZeRO, and
the engine's refusals under ZeRO. The ranks are
``tests/torch_zero_rank.py --mode dp2``."""

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
from deepspeed_tpu_torch.runtime.utils import jax_leaves
from deepspeed_tpu_torch.runtime.zero.partition import FLAT_ALIGN, build_units
from tests import torch_dp_rank as R
from tests import torch_zero_rank as Z
from tests.test_torch_training import LEAF_TOL, LOSS_TOL
from tests.torch_launch_util import ROOT, launch, rank_env

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

STAGES = (1, 2, 3)


def _jax_params(seed=3):
    cfg = JT.TransformerConfig(**R.LLAMA)
    return JaxCausalLM(cfg), jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(seed)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' records and gathered params, launched once."""
    out = tmp_path_factory.mktemp("zero_dp2")
    _, jparams = _jax_params()
    np.savez(out / "weights.npz", **R.flatten(jparams))
    launch(ROOT / "tests" / "torch_zero_rank.py", 2,
           ["--mode", "dp2", "--weights", str(out / "weights.npz"), "--out", str(out)],
           out / "logs", timeout=240, env=rank_env())
    ranks = []
    for r in range(2):
        rec = json.loads((out / f"dp2_rank_{r}.json").read_text())
        rec["out"], rec["params"] = out, {}
        for tag in ("stage0", "stage1", "stage2", "stage3", "stage3_all", "stage3_noremat",
                    "lamb", "lamb_noreduce", "SGD_stage0", "SGD_stage2", "Lion_stage0",
                    "Lion_stage2", "Adagrad_stage0", "Adagrad_stage2", "moq_stage0",
                    "moq_stage2", "bf16_stage0", "bf16_stage2", "bf16_stage3",
                    "client_stage0", "client_stage2"):
            with np.load(out / f"dp2_{tag}_rank_{r}.npz") as z:
                rec["params"][tag] = dict(z)
        ranks.append(rec)
    return ranks


def _jax_engine(config, steps_fn):
    saved = jcomm._mesh
    mesh = jax_build_mesh({"dp": 2}, devices=jax.devices()[:2])
    try:
        jmodel, jparams = _jax_params()
        eng, _, _, _ = deepspeed_tpu.initialize(model=jmodel, model_parameters=jparams,
                                                config=config, mesh=mesh)
        return steps_fn(eng)
    finally:
        jcomm.set_mesh(saved)


def _adam_steps(eng):
    losses, lrs = [], []
    for b in R.batches():
        losses.append(float(eng.train_batch(b)))
        lrs.append(float(eng.get_lr()[0]))
    return losses, lrs, R.flatten(jax.tree.map(np.asarray, eng.state.params))


@pytest.fixture(scope="module")
def jax_runs():
    return {s: _jax_engine(Z.zero_config(s), _adam_steps) for s in STAGES}


def _lamb_steps(eng):
    """Losses, params, and each step's trust ratio per JAX leaf from the
    engine's own state: ``||p|| / ||u||`` with ``u`` Adam's update from the
    new moments plus ``wd * p`` (optax ``scale_by_trust_ratio``)."""
    b1, b2 = Z.LAMB_CONFIG["optimizer"]["params"]["betas"]
    eps = Z.LAMB_CONFIG["optimizer"]["params"]["eps"]
    wd = Z.LAMB_CONFIG["optimizer"]["params"]["weight_decay"]
    losses, ratios = [], []
    for b in R.batches():
        p0 = R.flatten(jax.tree.map(lambda a: np.asarray(a, np.float64), eng.state.params))
        losses.append(float(eng.train_batch(b)))
        adam = eng.state.opt_state[0]
        t = int(adam.count)
        mu = R.flatten(jax.tree.map(lambda a: np.asarray(a, np.float64), adam.mu))
        nu = R.flatten(jax.tree.map(lambda a: np.asarray(a, np.float64), adam.nu))
        step = {}
        for k in p0:
            u = (mu[k] / (1 - b1**t)) / (np.sqrt(nu[k] / (1 - b2**t)) + eps) + wd * p0[k]
            pn, un = np.linalg.norm(p0[k]), np.linalg.norm(u)
            step[k] = pn / un if pn > 0 and un > 0 else 1.0
        ratios.append(step)
    return losses, ratios, R.flatten(jax.tree.map(np.asarray, eng.state.params))


@pytest.fixture(scope="module")
def jax_lamb():
    return _jax_engine(Z.zero_config(2, Z.LAMB_CONFIG), _lamb_steps)


def _leaf_errors(got, want, lrs):
    errs = {}
    for k in want:
        if k.endswith("attn/bk"):
            # the key bias's exact gradient is zero: Adam moves rounding
            # noise there by up to lr a step, in each package's own direction
            assert np.abs(got[k] - want[k]).max() <= 2 * sum(lrs), k
            continue
        errs[k] = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
    return errs


@pytest.mark.parametrize("tag", ["stage1", "stage2", "stage3", "stage3_all"])
def test_stage_matches_jax_engine_at_dp2(run, jax_runs, tag):
    want_losses, lrs, want = jax_runs[int(tag[5])]
    for rec in run:
        got = rec[tag]["losses"]
        assert rec[tag]["world"] == 2
        for step, (g, w) in enumerate(zip(got, want_losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), (rec["rank"] if "rank" in rec else 0, step)
    assert run[0][tag]["losses"] == run[1][tag]["losses"]
    p0, p1 = run[0]["params"][tag], run[1]["params"][tag]
    assert p0.keys() == want.keys()
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    errs = _leaf_errors(p0, want, lrs)
    assert max(errs.values()) <= LEAF_TOL, errs


def test_stage3_without_remat_gathers_each_layer_again(run):
    """Without remat the saved-tensor hooks keep a gathered layer's saved
    views as geometry and gather the layer again in the backward: the same
    bits as under remat, and no more gathered units alive at once than the
    embedding's window and one layer (without the hooks every layer and
    the head would be)."""
    for rec in run:
        got = rec["stage3_noremat"]
        assert got["losses"] == rec["stage3_all"]["losses"]
        assert got["peak_live_gathers"] <= 2 < R.LLAMA["n_layer"] + 2
        assert rec["stage3_all"]["peak_live_gathers"] <= 2
        for k, v in rec["params"]["stage3_all"].items():
            np.testing.assert_array_equal(rec["params"]["stage3_noremat"][k], v, err_msg=k)


@pytest.mark.parametrize("stage", STAGES)
def test_describe_is_the_jax_rules_text(run, stage):
    from jax.sharding import Mesh

    from deepspeed_tpu.runtime.zero.config import ZeroConfig as JaxZeroConfig
    from deepspeed_tpu.runtime.zero.partition import ZeroShardingRules as JaxRules
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    want = JaxRules(mesh, JaxZeroConfig(stage=stage)).describe()
    assert run[0][f"stage{stage}"]["describe"] == want


def _bound(full_bytes, world=2):
    """``ceil(full / n)`` plus the units' alignment and padding."""
    units = build_units([(k, v.shape) for k, v in _port_shapes().items()], world)
    pad = sum(u.padded - u.numel for u in units) * 4
    return math.ceil(full_bytes / world) + pad, units


def _port_shapes():
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    model = CausalLM(TransformerConfig(**R.LLAMA))
    return {n: p for n, p in model.init_params(torch.Generator().manual_seed(0))
            .named_parameters()}


@pytest.mark.parametrize("stage", STAGES)
def test_each_rank_holds_its_partition(run, stage):
    """After the steps, each rank's optimizer state is at most ceil(stage 0's
    / 2) plus padding (fp32 params: no masters); at stage >= 2 the gradient
    buffer too; at stage 3 the compute params as well, plus the units under
    the persistence threshold (none when it is 0)."""
    for rec in run:
        full, held = rec["stage0"]["held"], rec[f"stage{stage}"]["held"]
        opt_bound, units = _bound(full["optimizer"])
        assert held["optimizer"] <= opt_bound < full["optimizer"]
        grad_bound, _ = _bound(full["grads"])
        if stage >= 2:
            assert held["grads"] <= grad_bound < full["grads"]
        else:
            assert held["grads"] >= full["grads"]
        if stage == 3:
            persistent = sum(u.padded * 4 for u in units if u.numel < 100_000)
            assert held["params"] <= grad_bound + persistent < full["params"]
            assert rec["stage3_all"]["held"]["params"] <= grad_bound
        else:
            assert held["params"] >= full["params"]


def test_lamb_stage2_matches_jax_with_a_leaf_split_across_ranks(run, jax_lamb):
    want_losses, want_ratios, want = jax_lamb
    names = list(_port_shapes())
    groups = list(jax_leaves(names))
    split = [n for n in run[0]["lamb"]["segments"] if n in run[1]["lamb"]["segments"]]
    assert split, "no leaf has segments on both ranks"
    for rec in run:
        for g, w in zip(rec["lamb"]["losses"], want_losses):
            assert abs(g - w) <= LOSS_TOL * abs(w)
        for step, (got, w) in enumerate(zip(rec["lamb"]["ratios"], want_ratios)):
            assert len(got) == len(groups)
            for path, ratio in zip(groups, got):
                ref = w["/".join(path)]
                assert abs(ratio - ref) <= LEAF_TOL * abs(ref), (step, path, ratio, ref)
    p0, p1 = run[0]["params"]["lamb"], run[1]["params"]["lamb"]
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    errs = {k: float(np.abs(p0[k] - want[k]).max() / np.abs(want[k]).max())
            for k in want if not k.endswith("attn/bk")}
    assert max(errs.values()) <= LEAF_TOL, errs


def test_lamb_without_the_cross_rank_sum_reads_above_the_limit(run, jax_lamb):
    _, want_ratios, _ = jax_lamb
    groups = list(jax_leaves(list(_port_shapes())))
    worst = max(abs(ratio - want_ratios[0]["/".join(path)]) / want_ratios[0]["/".join(path)]
                for rec in run for path, ratio in zip(groups, rec["lamb_noreduce"]["ratios"][0]))
    assert worst > LEAF_TOL, worst


@pytest.mark.parametrize("a,b", [("health_stage0", "health_stage2"),
                                 ("health_lamb0", "health_lamb2")])
def test_health_sentinels_reduce_over_the_ranks(run, a, b):
    """Stage 2's sentinel vector (per-bucket grad norms, non-finite counts,
    param and update norms from each rank's segments, reduced once over the
    group) against stage 0's, each field within 1e-5 relative; AdamW and
    LAMB."""
    for rec in run:
        assert rec[b]["buckets"] == rec[a]["buckets"]
        for got, want in zip(rec[b]["sentinels"], rec[a]["sentinels"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _assert_ranks_equal(run, tag):
    assert run[0][tag] == run[1][tag]
    for k, v in run[0]["params"][tag].items():
        np.testing.assert_array_equal(run[1]["params"][tag][k], v, err_msg=k)


def test_callable_client_optimizer_trains_on_the_partitions(run):
    """A callable torch AdamW (elementwise) called over each rank's
    segments at stage 2 computes what it computes over the whole leaves at
    stage 0: per-step loss within ``LOSS_TOL``, every leaf within
    ``LEAF_TOL`` after 3 updates (the key-bias rule), both ranks
    bit-equal."""
    for rec in run:
        for g, w in zip(rec["client_stage2"], rec["client_stage0"]):
            assert abs(g - w) <= LOSS_TOL * abs(w)
    _assert_ranks_equal(run, "client_stage2")
    errs = _leaf_errors(run[0]["params"]["client_stage2"], run[0]["params"]["client_stage0"],
                        [Z.CLIENT_LR] * R.STEPS)
    assert max(errs.values()) <= LEAF_TOL, errs


def test_moq_on_partitions_matches_stage0(run):
    """LAMB with MoQ (stochastic rounding, 10 -> 8 bits) at stage 2: the
    quantizer runs on the compute params, which are whole at stages 1-2,
    with each leaf's seed; per-step loss within ``LOSS_TOL`` of stage 0,
    both ranks bit-equal, every element within ``LEAF_TOL`` but those
    that the two runs' fp32 noise put on either side of a rounding
    boundary (a share below 1e-3, each one quantization step off: the rule
    of ``test_moq_engine_matches_jax_engine``); a stacked matrix leaf holds
    no more values than its groups' 8-bit levels."""
    qmax = 2 ** (Z.MOQ_SR["quantize_bits"]["target_bits"] - 1) - 1
    for rec in run:
        for g, w in zip(rec["moq_stage2"], rec["moq_stage0"]):
            assert abs(g - w) <= LOSS_TOL * abs(w)
    _assert_ranks_equal(run, "moq_stage2")
    got, want = run[0]["params"]["moq_stage2"], run[0]["params"]["moq_stage0"]
    for k in want:
        d, scale = np.abs(got[k] - want[k]), np.abs(want[k]).max()
        assert (d > LEAF_TOL * scale).mean() <= 1e-3, k
        assert d.max() <= scale / qmax * 1.01 + LEAF_TOL * scale, k
    levels = R.LLAMA["n_layer"] * Z.MOQ_SR["quantize_groups"] * (2 * qmax + 1)
    assert len(np.unique(got["layers/attn/wq"])) <= levels


#: bf16 stages 2-3 against bf16 stage 0 over 2 ranks (gas 2, fp32
#: accumulation): the reduction runs in fp32 at every stage and only its
#: order differs. Readings (PERF.md): loss 0, leaf 1.43e-6 relative; with
#: stage 3 reducing in bf16 instead, loss 7.29e-6 and leaf 6.41e-3
BF16_LOSS_TOL, BF16_LEAF_TOL = 1e-6, 1e-4


@pytest.mark.parametrize("stage", [2, 3])
def test_bf16_stages_reduce_in_fp32_as_stage0(run, stage):
    tag = f"bf16_stage{stage}"
    for rec in run:
        for g, w in zip(rec[tag], rec["bf16_stage0"]):
            assert abs(g - w) <= BF16_LOSS_TOL * abs(w)
    _assert_ranks_equal(run, tag)
    errs = _leaf_errors(run[0]["params"][tag], run[0]["params"]["bf16_stage0"],
                        [3e-4] * R.STEPS)
    assert max(errs.values()) <= BF16_LEAF_TOL, errs


@pytest.mark.parametrize("tag", ["stage0", "stage1", "stage2", "stage3"])
def test_save_16bit_model_gathers_and_rank0_writes(run, tag):
    """Both ranks called ``save_16bit_model`` into one directory: the file
    holds every gathered leaf rounded to bf16."""
    with np.load(run[0]["out"] / f"model16_{tag}.npz") as z:
        saved = {k.split("::")[0].replace(".", "/"): v for k, v in z.items()}
    want = run[0]["params"][tag]
    assert sorted(saved) == sorted(want)
    for k, v in want.items():
        bits = torch.from_numpy(saved[k].view(np.int16)).view(torch.bfloat16)
        assert torch.equal(bits.float(), torch.from_numpy(v).bfloat16().float()), k


@pytest.mark.parametrize("name", ["SGD", "Lion", "Adagrad"])
def test_elementwise_optimizers_on_partitions(run, name):
    """SGD (momentum), Lion and Adagrad update each segment elementwise: at
    stage 2 their losses and params equal stage 0's within the JAX-parity
    tolerances (only the clip norm's summation differs), both ranks
    bit-equal."""
    for rec in run:
        for g, w in zip(rec[f"{name}_stage2"], rec[f"{name}_stage0"]):
            assert abs(g - w) <= LOSS_TOL * abs(w)
    got, want = run[0]["params"][f"{name}_stage2"], run[0]["params"][f"{name}_stage0"]
    for k in want:
        np.testing.assert_array_equal(run[1]["params"][f"{name}_stage2"][k], got[k])
        if not k.endswith("attn/bk"):
            assert float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) <= LEAF_TOL, k


def test_fp16_overflow_on_one_rank_skips_on_both_at_stage2(run):
    for rec in run:
        for step, s in enumerate(rec["fp16_stage2"]):
            skipped = step == R.OVERFLOW_STEP
            assert (s["applied"], s["unchanged"]) == (not skipped, skipped), (step, s)
        assert [s["scale"] for s in rec["fp16_stage2"]] == \
            [s["scale"] for s in run[0]["fp16_stage2"]]


@pytest.mark.parametrize("what,item", [
    ("moq_stage3", "queue 1: MoQ and compression under ZeRO-3"),
    ("client_built", "queue 1: client optimizer state under ZeRO"),
    ("client_state", "queue 1: client optimizer state under ZeRO"),
])
def test_refusals_under_zero_name_their_items(run, what, item):
    for rec in run:
        assert rec["refused"][what] is not None and item in rec["refused"][what], what


def test_units_align_every_leaf():
    units = build_units([(k, v.shape) for k, v in _port_shapes().items()], 2)
    assert [u.key for u in units] == ["embed", "layers.0", "layers.1", "head"]
    assert units[-1].names == ["lm_head", "ln_f.scale"]
    for u in units:
        assert all(o % FLAT_ALIGN == 0 for o in u.offsets)
        assert u.padded % (2 * FLAT_ALIGN) == 0 and u.block * 2 == u.padded
        segs = u.segments(0) + u.segments(1)
        assert sum(s.numel for s in segs) == u.numel
