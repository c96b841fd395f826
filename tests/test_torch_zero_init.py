"""``zero.Init``, ``GatheredParameters``, ``SparseTensor``, ``mpu`` and the
ZeRO config, against the JAX package (counterparts of
``tests/unit/test_zero_init.py`` and ``tests/unit/test_parity_extras.py:70-100``).
Two gloo ranks (``tests/torch_zero_rank.py --mode init``, no JAX) build the
tiny Llama under ``zero.Init`` (the values equal eager init's; each layer is
cut to the rank's block as it is made, so no earlier layer is alive when the
next is streamed, and a rank holds half the tree), train the engine built
at stage 3 with no params, modify and read through ``GatheredParameters``
(rank 0's copy wins on both ranks; read-only use changes nothing), reduce a
row-sparse gradient with ``sparse_all_reduce`` (equal to the JAX
``shard_map`` reduction over 2 devices) and take the data-parallel world
from an ``mpu``. Without ranks: ``SparseTensor``'s densify against JAX's,
the ZeRO config's fields against the JAX model's, ``describe()`` over
several meshes, and the refusals that remain outside the engine."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.runtime.sparse_tensor import SparseTensor as JaxSparseTensor
from deepspeed_tpu.runtime.sparse_tensor import sparse_all_reduce as jax_sparse_all_reduce
from deepspeed_tpu.runtime.zero.config import ZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.config import get_zero_config as jax_get_zero_config
from deepspeed_tpu.runtime.zero.partition import ZeroShardingRules as JaxRules
import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm.mesh import Mesh as PortMesh
from deepspeed_tpu_torch.config.core import DeepSpeedConfig
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor
from deepspeed_tpu_torch.runtime.zero.config import ZeroConfig, get_zero_config
from deepspeed_tpu_torch.runtime.zero.partition import ZeroShardingRules
from tests import torch_dp_rank as R
from tests import torch_zero_rank as Z
from tests.torch_launch_util import ROOT, launch, rank_env

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero_init")
    cfg = JT.TransformerConfig(**R.LLAMA)
    jparams = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.key(3)))
    np.savez(out / "weights.npz", **R.flatten(jparams))
    launch(ROOT / "tests" / "torch_zero_rank.py", WORLD,
           ["--mode", "init", "--weights", str(out / "weights.npz"), "--out", str(out)],
           out / "logs", timeout=180, env=rank_env())
    return [json.loads((out / f"init_rank_{r}.json").read_text()) for r in range(WORLD)]


def test_init_partitions_with_eager_values(run):
    for rec in run:
        init = rec["init"]
        assert init["type"] == "PartitionedParams" and init["equal"]
        assert init["streamed"] == R.LLAMA["n_layer"]
        # each layer was dropped before the next one was made
        assert init["peak_live_layers"] == 0
        assert init["held"] < init["full"] and init["held"] <= init["full"] // WORLD + 4096


def test_engine_at_stage3_builds_under_init(run):
    for rec in run:
        eng = rec["engine_init"]
        assert eng["type"] == "PartitionedParams" and eng["equal"]
        assert np.isfinite(eng["loss"])
    assert run[0]["engine_init"]["loss"] == run[1]["engine_init"]["loss"]


def test_gathered_parameters_modify_and_repartition(run):
    for rec in run:
        g = rec["gathered"]
        # every rank wrote 7 + rank; rank 0's copy is broadcast, as JAX's one copy
        assert g["embed_min"] == g["embed_max"] == 7.0
        assert g["others_equal"]
        assert g["readonly_equal"]


def _jax_sparse_reduced():
    ids, vals = Z.sparse_inputs(WORLD)
    vocab = Z.SPARSE[0]
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))

    def body(i, v):
        st = JaxSparseTensor.from_embedding_grad(i[0], v[0], vocab)
        return jax_sparse_all_reduce(st, "dp", average=True).to_dense()[None]

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                            out_specs=P("dp")))(jnp.asarray(ids), jnp.asarray(vals))
    return np.asarray(out)


def test_sparse_all_reduce_matches_jax_over_two_ranks(run):
    want = _jax_sparse_reduced()
    vocab, D, n = Z.SPARSE
    for r, rec in enumerate(run):
        sp = rec["sparse"]
        assert (sp["nnz"], sp["reduced_nnz"], sp["coo_shape"]) == (n, WORLD * n, [vocab, D])
        np.testing.assert_allclose(np.asarray(sp["dense"]), want[r], rtol=0, atol=1e-6)


def test_sparse_tensor_densify_matches_jax():
    ids = np.asarray([1, 3, 1], np.int32)
    vals = np.asarray([[1.0, 0.0], [0.0, 2.0], [4.0, 0.0]], np.float32)
    got = SparseTensor.from_embedding_grad(torch.from_numpy(ids), torch.from_numpy(vals), 5)
    want = JaxSparseTensor.from_embedding_grad(jnp.asarray(ids), jnp.asarray(vals), 5)
    np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))
    assert got.nnz == want.nnz == 3 and got.to_coo_tensor()[2] == want.to_coo_tensor()[2]


def test_mpu_names_the_data_parallel_world(run):
    for rec in run:
        m = rec["mpu"]
        assert m["dp_world"] == m["config_world"] == WORLD
        assert "mpu.get_data_parallel_world_size() is 4" in m["mismatch"]
        assert "queue 1: tensor-parallel training" in m["model_parallel"]


def test_mpu_without_a_process_group():
    model = CausalLM(TransformerConfig(**R.LLAMA))
    params = model.init_params(torch.Generator().manual_seed(0))
    cfg = {**R.CONFIG, "train_batch_size": 4}
    eng = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=cfg,
                                         mpu=Z.MPU(1), device="cpu")[0]
    assert eng.dp_world_size == 1 and eng.mpu is not None
    with pytest.raises(ValueError, match="data_parallel_world_size"):
        deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=cfg,
                                       mpu=Z.MPU(2), device="cpu")


@pytest.mark.parametrize("section", [
    {},
    {"stage": 2, "reduce_bucket_size": 5e7, "overlap_comm": False},
    {"stage": 3, "stage3_param_persistence_threshold": 7, "stage3_max_live_parameters": 3,
     "stage3_prefetch_bucket_size": 11, "stage3_gather_16bit_weights_on_model_save": True},
    {"stage": 1, "cpu_offload": True},
    {"stage": 3, "offload_param": {"device": "nvme", "nvme_path": "/x"}},
    {"stage": 2, "partition_axis": "fsdp", "sub_group_size": 4},
])
def test_zero_config_fields_match_jax(section):
    want, got = jax_get_zero_config({"zero_optimization": section}), \
        get_zero_config({"zero_optimization": section})
    for name in want.model_dump():
        w, g = getattr(want, name), getattr(got, name)
        if hasattr(w, "model_dump"):
            assert {k: (v.value if hasattr(v, "value") else v) for k, v in
                    w.model_dump().items()} == {k: getattr(g, k) for k in w.model_dump()}, name
        else:
            assert g == w, name
    assert got.offload_optimizer_device == want.offload_optimizer_device.replace(
        "OffloadDeviceEnum.", "")


def test_zero_config_deprecated_boolean_form():
    cfg = {"zero_optimization": True, "allgather_size": 123}
    want, got = jax_get_zero_config(cfg), get_zero_config(cfg)
    assert (got.stage, got.allgather_bucket_size) == (want.stage, want.allgather_bucket_size)


@pytest.mark.parametrize("axes,stage,threshold", [
    ({"dp": 8}, 1, None), ({"dp": 4, "fsdp": 2}, 3, None), ({"dp": 1}, 2, None),
    ({"dp": 2, "tp": 4}, 3, 0), ({"fsdp": 8}, 0, None),
])
def test_describe_matches_jax_rules(axes, stage, threshold):
    devs = np.array(jax.devices()[:8])
    names = tuple(axes)
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    jmesh = Mesh(devs[:n].reshape(shape), names)
    pmesh = PortMesh(np.arange(n).reshape(shape), names)
    extra = {} if threshold is None else {"stage3_param_persistence_threshold": threshold}
    want = JaxRules(jmesh, JaxZeroConfig(stage=stage, **extra))
    got = ZeroShardingRules(pmesh, ZeroConfig(stage=stage, **extra))
    assert got.describe() == want.describe()
    assert (got.axes, got.axis_size) == (want.axes, want.axis_size)


@pytest.mark.parametrize("config,world,match", [
    ({"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}, 2,
     "queue 1: ZeRO-Offload over dp"),
    ({"zero_optimization": {"stage": 0, "cpu_offload": True}}, 4,
     "queue 1: ZeRO-Offload over dp"),
    ({"mesh": {"dp": 1, "tp": 2}}, 1, "queue 1: tensor-parallel training"),
    ({"mesh": {"dp": 1, "sp": 2}}, 1, "queue 1: sequence/"),
    ({"mesh": {"pp": 2}}, 1, "queue 1: runtime/pipe/"),
])
def test_remaining_refusals_name_their_items(config, world, match):
    cfg = {"train_micro_batch_size_per_gpu": 1, **config}
    with pytest.raises(NotImplementedError, match=match):
        DeepSpeedConfig(cfg, world_size=world)


@pytest.mark.parametrize("world,stage", [(2, 1), (2, 2), (4, 3)])
def test_stages_and_fsdp_are_admitted(world, stage):
    cfg = {"train_micro_batch_size_per_gpu": 1, "mesh": {"dp": 2, "fsdp": world // 2},
           "zero_optimization": {"stage": stage}}
    got = DeepSpeedConfig(cfg, world_size=world)
    assert got.zero_config.stage == stage and got.world_size == world
