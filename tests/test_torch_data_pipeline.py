"""The port's data-efficiency pipeline (``runtime/data_pipeline``,
``runtime/progressive_layer_drop.py``) against the JAX package's on the CPU.

The curriculum's schedules give the JAX scheduler's difficulty at every
step 0..50; the engine's seqlen curriculum cuts each batch as the JAX
engine does (dim 2 of every ``[gas, B, S, ...]`` leaf, dim 3 of a square
``[.., S, S]`` leaf only) and trains to the JAX engine's losses (1e-5
relative, the tolerance of ``tests/test_torch_training.py``), from the legacy
section and from ``data_efficiency`` with its parent switches as gates;
after a save and a load the host step counter, the curriculum's clock,
resumes where it was. The indexed dataset, the analyzer and the sampler
are numpy in both packages, so their outputs are equal, and a file written
by either package is read by the other. Progressive layer drop's theta
follows the JAX schedule, and neither engine moves it by itself.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcs
from deepspeed_tpu.runtime.data_pipeline.data_sampling import data_analyzer as jda
from deepspeed_tpu.runtime.data_pipeline.data_sampling import data_sampler as jds
from deepspeed_tpu.runtime.data_pipeline.data_sampling import indexed_dataset as jid
from deepspeed_tpu.runtime.progressive_layer_drop import ProgressiveLayerDrop as JaxPLD
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as pcs
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_analyzer as pda
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_sampler as pds
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import indexed_dataset as pid
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

LOSS_TOL = 1e-5     # relative, per step (tests/test_torch_training.py)
SCHEDULES = {
    "fixed_linear": {"curriculum_type": "seqlen", "min_difficulty": 128, "max_difficulty": 512,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 37, "difficulty_step": 8}},
    "fixed_linear_unaligned": {"min_difficulty": 10, "max_difficulty": 100,
                               "schedule_type": "fixed_linear",
                               "schedule_config": {"total_curriculum_step": 13,
                                                   "difficulty_step": 6}},
    "fixed_root": {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 1024,
                   "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 40, "difficulty_step": 8,
                                       "root_degree": 3}},
    "fixed_discrete": {"curriculum_type": "seqlen", "min_difficulty": 1, "max_difficulty": 3,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 2, 3], "max_step": [5, 20]}},
    "custom": {"schedule_type": "custom"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    got, want = pcs.CurriculumScheduler(dict(SCHEDULES[name])), \
        jcs.CurriculumScheduler(dict(SCHEDULES[name]))
    if name == "custom":
        for s in (got, want):
            s.set_custom_get_difficulty(lambda step: 16 + 3 * step)
    assert got.get_state() == want.get_state()
    for step in range(51):
        assert got.get_difficulty(step) == want.get_difficulty(step), step
        assert got.update_difficulty(step) == want.update_difficulty(step), step
    assert got.get_state() == want.get_state()


@pytest.mark.parametrize("bad", [
    {"schedule_type": "fixed_linear", "min_difficulty": 8},
    {"schedule_type": "fixed_root", "min_difficulty": 8, "max_difficulty": 16,
     "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}},
    {"schedule_type": "fixed_discrete", "min_difficulty": 1, "max_difficulty": 2,
     "schedule_config": {"difficulty": [1, 2], "max_step": [1, 2]}},
    {"schedule_type": "cosine", "min_difficulty": 1, "max_difficulty": 2},
])
def test_bad_schedules_raise_in_both(bad):
    with pytest.raises(ValueError):
        jcs.CurriculumScheduler(dict(bad))
    with pytest.raises(ValueError):
        pcs.CurriculumScheduler(dict(bad))


# ------------------------------------------------------------------ #
# the engine's seqlen curriculum

LLAMA = dict(vocab_size=128, max_seq=32, n_layer=1, n_head=2, d_model=32, d_ff=64,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             attention_backend="xla", remat=False)
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
              "max_difficulty": 32, "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}}
S = 32


def _config(sections):
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "steps_per_print": 0, "fused_cross_entropy": "off", **sections}


class Recorder:
    """A loss over a batch with extra leaves: a square ``[B, S, S]`` mask,
    ``[B, S, 8]`` features and a ``[B, S, 3, S]`` leaf whose last dim equals
    S; each adds its mean to the LM loss, so the loss tells how each was
    cut. ``shapes`` records what each call saw."""

    def __init__(self, model):
        self.model, self.shapes = model, []

    def loss(self, params, batch, rng=None):
        self.shapes.append({k: tuple(v.shape) for k, v in batch.items()})
        extra = sum(batch[k].mean() for k in ("pair_mask", "feats", "wide"))
        return self.model.loss(params, {"input_ids": batch["input_ids"]}) + 1e-3 * extra


def _batches(n=6):
    r = np.random.default_rng(5)
    return [{"input_ids": r.integers(0, 128, size=(4, S)).astype(np.int32),
             "pair_mask": r.standard_normal((4, S, S)).astype(np.float32),
             "feats": r.standard_normal((4, S, 8)).astype(np.float32),
             "wide": r.standard_normal((4, S, 3, S)).astype(np.float32)} for _ in range(n)]


@pytest.fixture(scope="module")
def one_device_mesh():
    from deepspeed_tpu.comm import comm as jdist
    from deepspeed_tpu.comm.mesh import build_mesh
    saved = jdist._mesh
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def _engines(sections, mesh):
    jcfg = JT.TransformerConfig(**LLAMA)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(1)))
    jrec = Recorder(JaxCausalLM(jcfg))
    jeng = deepspeed_tpu.initialize(model=jrec, model_parameters=tree, config=_config(sections),
                                    mesh=mesh)[0]
    model = CausalLM(TransformerConfig(**LLAMA))
    prec = Recorder(model)
    peng = deepspeed_tpu_torch.initialize(model=prec, model_parameters=params_from_jax(
        model.config, tree), config=_config(sections), device="cpu")[0]
    return jeng, jrec, peng, prec


@pytest.mark.parametrize("sections", [
    {"curriculum_learning": CURRICULUM},
    {"data_efficiency": {"enabled": True, "data_sampling": {
        "enabled": True, "curriculum_learning": CURRICULUM}}},
])
def test_engine_cuts_and_trains_as_jax(one_device_mesh, sections):
    jeng, jrec, peng, prec = _engines(sections, one_device_mesh)
    assert peng.curriculum_scheduler is not None and jeng.curriculum_scheduler is not None
    for step, batch in enumerate(_batches()):
        want, got = float(jeng.train_batch(batch)), float(peng.train_batch(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want), (step, got, want)
        assert peng.curriculum_scheduler.get_state() == jeng.curriculum_scheduler.get_state()
    # the JAX loss traces once a shape; the port's runs once a micro-step
    want = {tuple(sorted(s.items())) for s in jrec.shapes}
    got = [tuple(sorted(s.items())) for s in prec.shapes]
    assert set(got) == want
    seqs = [dict(s)["input_ids"][1] for s in got[::2]]
    assert seqs == [16, 24, 32, 32, 32, 32]
    for s in map(dict, got):
        n = s["input_ids"][1]
        assert s["pair_mask"] == (2, n, n) and s["feats"] == (2, n, 8)
        assert s["wide"] == (2, n, 3, S)       # a later dim equal to S stays whole
    assert peng._host_global_steps == 6


@pytest.mark.parametrize("sections", [
    {"data_efficiency": {"enabled": False, "data_sampling": {
        "enabled": True, "curriculum_learning": CURRICULUM}}},
    {"data_efficiency": {"enabled": True, "data_sampling": {
        "enabled": False, "curriculum_learning": CURRICULUM}}},
    {"curriculum_learning": {**CURRICULUM, "enabled": False}},
])
def test_parent_switches_gate_the_curriculum(one_device_mesh, sections):
    jeng, _, peng, _ = _engines(sections, one_device_mesh)
    assert peng.curriculum_scheduler is None and jeng.curriculum_scheduler is None
    assert peng.curriculum_enabled_legacy() == jeng.curriculum_enabled_legacy()


def test_engine_flags_and_pld_match_jax(one_device_mesh):
    sections = {"progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.01},
                "curriculum_learning": CURRICULUM,
                "data_efficiency": {"data_routing": {"random_ltd": {"enabled": True}}}}
    jeng, _, peng, _ = _engines(sections, one_device_mesh)
    for name in ("pld_enabled", "curriculum_enabled_legacy", "random_ltd_enabled",
                 "get_pld_theta"):
        assert getattr(peng, name)() == getattr(jeng, name)(), name
    # neither engine moves theta: the user calls update_state
    batch = _batches(1)[0]
    jeng.train_batch(batch)
    peng.train_batch(batch)
    assert peng.get_pld_theta() == jeng.get_pld_theta() == 1.0
    for step in (0, 1, 10, 100, 1000):
        peng.progressive_layer_drop.update_state(step)
        jeng.progressive_layer_drop.update_state(step)
        assert peng.get_pld_theta() == jeng.get_pld_theta(), step
    assert peng.progressive_layer_drop.get_state() == jeng.progressive_layer_drop.get_state()
    off = _engines({}, one_device_mesh)
    assert off[2].get_pld_theta() is None and not off[2].pld_enabled()
    assert not off[2].random_ltd_enabled() and off[0].get_pld_theta() is None


def test_pld_schedule_matches_jax():
    got, want = ProgressiveLayerDrop(theta=0.3, gamma=0.002), JaxPLD(theta=0.3, gamma=0.002)
    assert got.get_theta() == want.get_theta() == 1.0
    for step in range(0, 3000, 37):
        got.update_state(step)
        want.update_state(step)
        assert got.get_theta() == want.get_theta()
        assert got.get_state() == want.get_state()


def test_counter_resumes_after_save_and_load(tmp_path):
    """Two steps, a save, a new engine loaded from it: its host step
    counter is 2, so its next step's cut is the uninterrupted run's."""
    tree = jax.tree.map(np.asarray, JT.init_params(JT.TransformerConfig(**LLAMA),
                                                   jax.random.key(1)))

    def engine():
        model = CausalLM(TransformerConfig(**LLAMA))
        rec = Recorder(model)
        return deepspeed_tpu_torch.initialize(
            model=rec, model_parameters=params_from_jax(model.config, tree),
            config=_config({"curriculum_learning": CURRICULUM}), device="cpu")[0], rec

    batches = _batches(3)
    whole, whole_rec = engine()
    for b in batches:
        whole.train_batch(b)
    first, _ = engine()
    for b in batches[:2]:
        first.train_batch(b)
    first.save_checkpoint(str(tmp_path))
    resumed, rec = engine()
    resumed.load_checkpoint(str(tmp_path))
    assert resumed._host_global_steps == 2
    resumed.train_batch(batches[2])
    assert rec.shapes == whole_rec.shapes[4:]
    assert resumed.curriculum_scheduler.get_current_difficulty() == \
        whole.curriculum_scheduler.get_current_difficulty()


# ------------------------------------------------------------------ #
# indexed datasets, the analyzer and the sampler

SAMPLES = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10], [11, 12]]


@pytest.mark.parametrize("fmt", ["dstpu", "megatron"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_indexed_dataset_reads_across_packages(tmp_path, fmt, writer):
    mods = {"jax": jid, "port": pid}
    prefix = str(tmp_path / "data")
    b = mods[writer].MMapIndexedDatasetBuilder(prefix, dtype=np.uint16, fmt=fmt)
    for i, s in enumerate(SAMPLES):
        b.add_item(s)
        if i in (1, 3):
            b.end_document()
    b.finalize()
    reads = [mods[r].MMapIndexedDataset(prefix) for r in ("jax", "port")]
    for ds in reads:
        assert len(ds) == len(SAMPLES) and ds[0].dtype == np.uint16
        np.testing.assert_array_equal(ds.sizes, [len(s) for s in SAMPLES])
        np.testing.assert_array_equal(ds.doc_idx, [0, 2, 4, 5])
        for i, s in enumerate(SAMPLES):
            np.testing.assert_array_equal(ds[i], s)
        np.testing.assert_array_equal(ds.get(2, offset=1, length=2), [7, 8])
    assert pid.MMapIndexedDataset.exists(prefix) and not pid.MMapIndexedDataset.exists(prefix + "x")
    # merging keeps the source's document boundaries in both
    for m in ("jax", "port"):
        dst = str(tmp_path / f"merged_{m}")
        b2 = mods[m].MMapIndexedDatasetBuilder(dst, dtype=np.uint16, fmt=fmt)
        b2.add_item([9])
        b2.end_document()
        b2.merge_file_(prefix)
        b2.finalize()
    with open(str(tmp_path / "merged_jax.idx"), "rb") as f, \
            open(str(tmp_path / "merged_port.idx"), "rb") as g:
        assert f.read() == g.read()


def test_megatron_fixture_and_v1_index(tmp_path):
    """The reference's MMIDIDX layout and a v1 DSTPUIDX index (no document
    section), written by hand, read as the JAX reader reads them."""
    import struct
    prefix = str(tmp_path / "megatron")
    flat = np.concatenate([np.asarray(s, np.int32) for s in SAMPLES])
    with open(prefix + ".bin", "wb") as f:
        f.write(flat.tobytes())
    sizes = np.asarray([len(s) for s in SAMPLES], np.int32)
    pointers = np.concatenate([[0], np.cumsum(sizes[:-1], dtype=np.int64) * 4])
    with open(prefix + ".idx", "wb") as f:
        f.write(b"MMIDIDX\x00\x00" + struct.pack("<QBQQ", 1, 4, len(sizes), 3))
        f.write(sizes.tobytes() + pointers.astype(np.int64).tobytes())
        f.write(np.asarray([0, 2, 5], np.int64).tobytes())
    v1 = str(tmp_path / "v1")
    with open(v1 + ".bin", "wb") as f:
        f.write(flat.tobytes())
    with open(v1 + ".idx", "wb") as f:
        f.write(b"DSTPUIDX" + struct.pack("<QBQ", 1, 4, len(sizes)))
        f.write(sizes.astype(np.int64).tobytes() + pointers.astype(np.int64).tobytes())
    for p in (prefix, v1):
        got, want = pid.MMapIndexedDataset(p), jid.MMapIndexedDataset(p)
        np.testing.assert_array_equal(got.doc_idx, want.doc_idx)
        assert [list(x) for x in got[:]] == [list(x) for x in want[:]]
    with open(str(tmp_path / "bad.idx"), "wb") as f:
        f.write(b"NOTANIDX" + bytes(17))
    open(str(tmp_path / "bad.bin"), "wb").close()
    with pytest.raises(ValueError, match="bad magic"):
        pid.MMapIndexedDataset(str(tmp_path / "bad"))


def _dataset(n=48, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(0, 50, size=r.integers(4, 33)).tolist() for _ in range(n)]


@pytest.mark.parametrize("workers", [1, 3])
def test_analyzer_matches_jax(tmp_path, workers):
    data = _dataset()
    vocab = 50

    def hist(sample):
        return np.bincount(np.asarray(sample), minlength=vocab)

    for name, mod in (("jax", jda), ("port", pda)):
        path = str(tmp_path / name)
        for w in range(workers):
            a = mod.DataAnalyzer(data, ["seqlen", "tokfreq"], [len, hist], path,
                                 num_workers=workers, worker_id=w,
                                 metric_types=[mod.SINGLE_VALUE, mod.ACCUMULATE])
            if workers == 1:
                a.run()
            else:
                a.run_map()
        if workers > 1:
            mod.DataAnalyzer(data, ["seqlen", "tokfreq"], [len, hist], path,
                             num_workers=workers, worker_id=0,
                             metric_types=[mod.SINGLE_VALUE, mod.ACCUMULATE]).run_reduce()
    port, jx = str(tmp_path / "port"), str(tmp_path / "jax")
    for metric in ("seqlen", "tokfreq"):
        for reader in (jda, pda):          # each package reads the other's files
            np.testing.assert_array_equal(reader.load_metric_values(port, metric),
                                          reader.load_metric_values(jx, metric))
    assert pda.load_metric_index(port, "seqlen") == jda.load_metric_index(jx, "seqlen")
    assert list(pda.load_metric_values(port, "seqlen")) == [len(s) for s in data]
    for pct in ((10, 50, 90), (25, 75)):
        assert pda.get_metric_value_percentiles(port, "seqlen", pct) == \
            jda.get_metric_value_percentiles(jx, "seqlen", pct)
    with pytest.raises(ValueError, match="unknown metric type"):
        pda.DataAnalyzer(data, ["x"], [len], port, metric_types=["other"])


def _sampler_pair(seed=7, curriculum=True, **kw):
    diffs = [len(s) for s in _dataset()]
    sched = dict(min_difficulty=8, max_difficulty=32, schedule_type="fixed_linear",
                 schedule_config={"total_curriculum_step": 6, "difficulty_step": 8})
    out = []
    for mod, cmod in ((pds, pcs), (jds, jcs)):
        out.append(mod.DeepSpeedDataSampler(
            len(diffs), micro_batch_size=4, data_parallel_rank=kw.get("rank", 0),
            data_parallel_size=kw.get("dp", 1), gradient_accumulation_steps=2,
            curriculum_scheduler=cmod.CurriculumScheduler(dict(sched)) if curriculum else None,
            difficulties=diffs if curriculum else None, seed=seed))
    return out


@pytest.mark.parametrize("curriculum", [True, False])
@pytest.mark.parametrize("rank,dp", [(0, 1), (1, 2)])
def test_sampler_matches_jax(curriculum, rank, dp):
    got, want = _sampler_pair(curriculum=curriculum, rank=rank, dp=dp)
    assert len(got) == len(want)
    assert list(got) == list(want)
    assert got.state_dict() == want.state_dict()
    # resumed from its state, it yields the rest of the epoch as JAX's does
    got, want = _sampler_pair(curriculum=curriculum, rank=rank, dp=dp)
    it_g, it_w = iter(got), iter(want)
    for _ in range(3):
        assert next(it_g) == next(it_w)
    g2, w2 = _sampler_pair(seed=99, curriculum=curriculum, rank=rank, dp=dp)
    g2.load_state_dict(got.state_dict())
    w2.load_state_dict(want.state_dict())
    assert list(g2) == list(w2)


def test_loader_takes_the_samplers_micro_batches():
    """DeepSpeedDataLoader at the sampler's micro-batch size yields its
    micro-batches in order; a fresh sampler with the same seed repeats it."""
    data = [np.full(4, i, np.int32) for i in range(48)]
    sampler, _ = _sampler_pair()
    loader = DeepSpeedDataLoader(data, 4, data_sampler=sampler)
    batches = [b[:, 0].tolist() for b in loader]
    assert batches == list(_sampler_pair()[0])
