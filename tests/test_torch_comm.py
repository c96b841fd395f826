"""``deepspeed_tpu_torch.comm`` at 2 and 4 gloo ranks on the CPU against
the JAX package's eager collectives on a mesh of as many CPU devices.

The ranks (``tests/torch_comm_rank.py``, started by the port's
``launcher/launch.py``, no JAX) run every collective of its ``CASES`` on
their cut of seeded numpy inputs; here the JAX call on the stacked array of
the same inputs gives the reference. Rank ``i`` must equal slice ``i`` of
JAX's result (the whole result where JAX's is replicated): limit 0 for SUM,
AVG, MAX, MIN and the data movers, 1e-6 relative for PRODUCT (JAX's
sign-aware log / exp formula, evaluated by each package's own log and exp;
in bf16 one ulp from JAX's jitted collective and limit 0 against the same
formula run by JAX op by op).
The comms logger's records (op, message size, count) must equal JAX's for
the same calls. A 4-rank ``{"dp": 2, "tp": 2}`` mesh checks each group's
members and size, ``axis_index``, ``get_global_rank`` and a SUM and a
gather over each group against JAX's mesh. ``send`` / ``recv`` raise as
JAX's do.

gloo on this torch (2.13) has ``AVG``, ``reduce_scatter_tensor`` and bf16
reductions natively, so the port builds none of them from SUM; the pair's
ranks call each at the torch level to keep that finding checked."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.comm as jdist
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm.mesh import build_mesh as jax_build_mesh
import deepspeed_tpu_torch.comm as pdist
from tests import torch_comm_rank as R
from tests.torch_launch_util import ROOT, launch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

PRODUCT_TOL = 1e-6        # relative


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("comm_pair")
    launch(ROOT / "tests" / "torch_comm_rank.py", R.N, ["--out", str(out), "--mode", "pair"],
           out / "logs", timeout=120)
    ranks = []
    for r in range(R.N):
        with np.load(out / f"rank_{r}.npz") as z:
            arrays = dict(z)
        with open(out / f"rank_{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return ranks


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    out = tmp_path_factory.mktemp("comm_mesh4")
    launch(ROOT / "tests" / "torch_comm_rank.py", 4, ["--out", str(out), "--mode", "mesh4"],
           out / "logs", timeout=120)
    return [json.load(open(out / f"rank_{r}.json")) for r in range(4)]


@pytest.fixture
def jax_mesh():
    """The JAX package's global mesh set to ``{"dp": N}`` over N CPU
    devices for the test, restored after."""
    saved = jcomm._mesh
    mesh = jax_build_mesh({"dp": R.N}, devices=jax.devices()[:R.N])
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(saved)


def _jax_case(case):
    """JAX's result for ``case`` on the stacked input, as fp32 numpy."""
    arrays = R.inputs()
    key, dt, cut, (fn, kw) = R.CASES[case]
    x = arrays[key] + 100.0 * kw.get("src", 0) if cut == "src" else arrays[key]
    x = jnp.asarray(x, jnp.bfloat16 if dt == "bf16" else jnp.float32)
    kw = {k: getattr(jdist.ReduceOp, v) if k == "op" else v for k, v in kw.items()}
    if fn in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        y = getattr(jdist, fn)(None, x, **kw)
    else:
        y = getattr(jdist, fn)(x, **kw)
    return np.asarray(jnp.asarray(y, jnp.float32))


def _want(case, y, rank):
    """Rank ``rank``'s slice of JAX's result."""
    _, _, cut, (fn, kw) = R.CASES[case]
    if fn in ("all_gather", "gather", "all_gather_into_tensor"):
        return y                                    # replicated
    if fn == "scatter":
        return np.split(y, R.N, axis=kw.get("axis", 0))[rank]
    if cut == "drop":
        return y[rank]
    return np.split(y, R.N, axis=0)[rank]


def _product_op_by_op(rank):
    """JAX's sign-aware PRODUCT (``comm.py:344-351``) in bf16 with each op
    run eagerly by JAX on one device: rank ``rank``'s slice."""
    x = jnp.asarray(R.inputs()["p"], jnp.bfloat16)
    logs = jnp.log(jnp.abs(x))
    magnitude = jnp.exp(logs[0] + logs[1])
    neg_count = (x < 0).astype(x.dtype)
    sign = 1.0 - 2.0 * ((neg_count[0] + neg_count[1]) % 2)
    return np.asarray(jnp.asarray(sign * magnitude, jnp.float32))[None]


@pytest.mark.parametrize("case", sorted(R.CASES))
def test_collective_equals_jax_slice_for_slice(pair, jax_mesh, case):
    y = _jax_case(case)
    for rank, (arrays, info) in enumerate(pair):
        got, want = arrays[case], _want(case, y, rank)
        assert got.shape == want.shape, (case, rank, got.shape, want.shape)
        if case == "all_reduce_PRODUCT_bf16":
            # XLA's jitted CPU log / exp are not torch's or numpy's: after the
            # bf16 rounding of the result, JAX's collective and the port part
            # by one ulp; the formula evaluated by JAX op by op is the port's
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
            assert (np.abs(got - want) <= ulp).all(), (case, rank)
            np.testing.assert_array_equal(got, _product_op_by_op(rank), err_msg=case)
        elif "PRODUCT" in case:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= PRODUCT_TOL, (case, rank, err)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{case} rank {rank}")


def test_ranks_ran_on_gloo_in_a_world_of_two(pair):
    for rank, (arrays, info) in enumerate(pair):
        assert info["backend"] == "gloo" and info["world"] == R.N and info["rank"] == rank
        np.testing.assert_array_equal(arrays["barrier"], np.zeros(1, np.float32))


def test_gloo_has_avg_reduce_scatter_tensor_and_bf16_natively(pair):
    """The ops the port calls natively on gloo, at the torch level: the
    bf16 AVG of (1 + rank, 3) and reduce_scatter_tensor of arange(4) x
    (rank + 1)."""
    for rank, (_, info) in enumerate(pair):
        assert info["native"]["avg_bf16"] == [1.5, 3.0]
        assert info["native"]["reduce_scatter_tensor"] == [[0.0, 3.0], [6.0, 9.0]][rank]


def test_comms_logger_records_equal_jax(pair, jax_mesh):
    """The same calls, in the same order, through JAX's logger: every op's
    message sizes and counts equal each rank's."""
    cl = jdist.comms_logger()
    saved = (cl.enabled, cl.prof_all, cl.comms_dict)
    cl.comms_dict = {}
    jdist.configure(enabled=True, prof_all=True)
    try:
        for case in R.CASES:
            _jax_case(case)
        jdist.barrier()
        want = {name: {str(size): rec[0] for size, rec in sizes.items()}
                for name, sizes in cl.comms_dict.items()}
    finally:
        cl.enabled, cl.prof_all, cl.comms_dict = saved
    for _, info in pair:
        assert info["records"] == want


def _jax_slices(mesh, axes):
    """JAX's group slices: for each device id, the ids of its slice along
    ``axes`` in group order (row-major over ``axes`` as given)."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    rest = [a for a in mesh.axis_names if a not in axes]
    order = [mesh.axis_names.index(a) for a in rest + list(axes)]
    rows = ids.transpose(order).reshape(-1, int(np.prod([mesh.shape[a] for a in axes])))
    return {int(d): [int(x) for x in row] for row in rows for d in row}


def test_mesh4_groups_match_jax(mesh4):
    mesh = jax_build_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert sorted(ids.ravel().tolist()) == [0, 1, 2, 3]
    saved = jcomm._mesh
    jdist.set_mesh(mesh)
    try:
        for key, group in R.GROUPS.items():
            axes = jcomm._resolve_axes(group)
            slices = _jax_slices(mesh, axes)
            size = jdist.get_world_size(group)
            for rank, rec in enumerate(mesh4):
                g = rec["groups"][key]
                assert g["size"] == size, (key, rank)
                assert g["members"] == slices[rank], (key, rank, g["members"], slices[rank])
                assert g["global_ranks"] == slices[rank], (key, rank)
                assert g["sum"] == float(sum(slices[rank])), (key, rank)
                assert g["gathered"] == [float(m) for m in slices[rank]], (key, rank)
        coords = {int(ids[i, j]): {"dp": i, "tp": j} for i in range(2) for j in range(2)}
        for rank, rec in enumerate(mesh4):
            assert rec["axis_index"] == coords[rank]
    finally:
        jdist.set_mesh(saved)


def test_send_and_recv_raise_as_jax():
    t = torch.zeros(2)
    for name in ("send", "recv", "isend", "irecv"):
        with pytest.raises(NotImplementedError) as got:
            getattr(pdist, name)(t, 0)
        with pytest.raises(NotImplementedError) as want:
            getattr(jdist, name)(jnp.zeros(2), 0)
        assert str(got.value) == str(want.value)


def test_bare_process_returns_its_input():
    """Without a process group a collective is the identity on its input
    and the world is one rank, as on JAX's mesh of one device."""
    assert not pdist.has_process_group()
    x = torch.arange(6.0)
    for fn in (pdist.all_reduce, pdist.all_gather, pdist.broadcast, pdist.ring_send_recv):
        assert fn(x) is x
    assert pdist.get_world_size() == 1 and pdist.get_rank() == 0


@pytest.mark.parametrize("axes,n", [({"dp": -1}, 8), ({"dp": 2, "tp": -1}, 8),
                                    ({"tp": 2, "pp": 2, "dp": 2}, 8), ({"sp": 2, "ep": 2}, 4)])
def test_build_mesh_equals_jax_layout(axes, n):
    """The rank grid of ``build_mesh`` over n ranks: the JAX mesh's device
    ids over n devices, axis names in the same canonical order."""
    from deepspeed_tpu_torch.comm.mesh import build_mesh
    want = jax_build_mesh(axes, devices=jax.devices()[:n])
    got = build_mesh(axes, ranks=range(n))
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.ranks, np.vectorize(lambda d: d.id)(want.devices))


@pytest.mark.parametrize("axes,n,err", [({"dp": 3}, 8, "product"), ({"dp": -1, "tp": -1}, 8, "-1"),
                                        ({"dp": 3, "tp": -1}, 8, "divisible")])
def test_build_mesh_refuses_as_jax(axes, n, err):
    from deepspeed_tpu_torch.comm.mesh import build_mesh
    with pytest.raises(ValueError, match=err):
        build_mesh(axes, ranks=range(n))
    with pytest.raises(ValueError, match=err):
        jax_build_mesh(axes, devices=jax.devices()[:n])


def test_hybrid_mesh_puts_nodes_outermost():
    """dcn axes outermost, as ``create_hybrid_device_mesh`` lays them out:
    2 nodes of 4 ranks, dp across the nodes and tp within each."""
    from deepspeed_tpu_torch.comm.mesh import Mesh
    import deepspeed_tpu_torch.comm.mesh as pm
    real = pm._world_ranks
    pm._world_ranks = lambda: list(range(8))
    try:
        got = pm.build_hybrid_mesh({"dp": 1, "tp": 4}, {"dp": 2, "tp": 1})
        two = pm.build_hybrid_mesh({"dp": 2, "tp": 2}, {"dp": 2, "tp": 1})
    finally:
        pm._world_ranks = real
    assert isinstance(got, Mesh) and got.shape == {"dp": 2, "tp": 4}
    np.testing.assert_array_equal(got.ranks, np.arange(8).reshape(2, 4))
    # dp index = node * 2 + local dp: node 0 holds dp rows 0-1
    np.testing.assert_array_equal(two.ranks, np.arange(8).reshape(4, 2))


def test_a_bare_init_then_an_explicit_world_makes_the_group(monkeypatch):
    """A bare process's ``init_distributed()`` (what every engine calls)
    creates nothing; a later call given ``rank`` / ``world_size`` still
    creates the group, and ``destroy_process_group`` ends it."""
    from tests.torch_launch_util import free_port
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    assert not pdist.has_process_group()
    pdist.init_distributed(verbose=False)
    assert pdist.is_initialized() and not pdist.has_process_group()
    pdist.init_distributed(dist_backend="gloo", rank=0, world_size=1, verbose=False)
    try:
        assert pdist.has_process_group() and pdist.get_world_size() == 1
        x = torch.arange(4.0)
        y = pdist.all_reduce(x, op=pdist.ReduceOp.AVG)
        assert y is not x and torch.equal(y, x)
    finally:
        pdist.destroy_process_group()
    assert not pdist.has_process_group() and not pdist.is_initialized()
