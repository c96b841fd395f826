"""ZeRO-Inference weight streaming in the port (``zero.offload_param.device``
"cpu" or "nvme": the layer weights in host RAM or in one file a layer, two
layer buffers on the engine's device) against the JAX package's streamed
engine, the counterparts of ``tests/unit/test_zero_inference.py``. The same
weights cross with ``params_from_jax``; tokens are equal and logits within
the JAX file's ``rtol=2e-4, atol=2e-4`` (fp32, attention_backend "xla").
The JAX file's two tp cases become the port's "sharded serving" refusal;
MoE and post-LN are refused as in the JAX engine; ``generate_batch`` takes
the static path and a serving session is refused."""

import gc
import glob
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as dist
import deepspeed_tpu_torch
from deepspeed_tpu.models.causal_lm import CausalLM as JaxCausalLM
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
from deepspeed_tpu_torch.ops.quant import Quantized8

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

RTOL = ATOL = 2e-4
BASE = dict(vocab_size=64, n_layer=3, n_head=4, d_model=32, d_ff=64, max_seq=256,
            remat=False, attention_backend="xla")


@pytest.fixture(autouse=True)
def no_mesh():
    dist.set_mesh(None)
    yield


def _zero(device, path=None):
    off = {"device": device}
    if path is not None:
        off["nvme_path"] = str(path)
    return {"stage": 3, "offload_param": off}


class _Pair:
    """One seeded tiny model in both packages."""

    def __init__(self, **over):
        kw = {**BASE, **over}
        self.jmodel = JaxCausalLM(JaxConfig(**kw))
        self.jparams = self.jmodel.init_params(jax.random.key(0))
        self.pmodel = CausalLM(TransformerConfig(**kw))
        self.params = params_from_jax(self.pmodel.config,
                                      jax.tree.map(np.asarray, self.jparams))

    def jax(self, **cfg):
        dist.set_mesh(None)
        return deepspeed_tpu.init_inference(self.jmodel, params=self.jparams,
                                            **{"dtype": "fp32", **cfg})

    def port(self, **cfg):
        return deepspeed_tpu_torch.init_inference(self.pmodel, params=self.params, device="cpu",
                                                  **{"dtype": "fp32", **cfg})


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def _toks(seed, shape=(2, 10)):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_streamed_layers_leave_the_device_tree(pair, device, tmp_path):
    eng = pair.port(zero=_zero(device, tmp_path))
    assert eng._stream_weights and eng._stream_nvme == (device == "nvme")
    assert "layers" not in eng.params.to_dict()
    if device == "cpu":
        # one host slab, each layer a stride of it
        assert eng._host_layers.nbytes == 3 * eng._stream_layout.stride
        assert eng._stream_layout.stride % 4096 == 0
    else:
        assert eng._host_layers is None        # nothing resident in host RAM
        files = sorted(os.listdir(eng._swap_dir))
        assert files == ["L0.swp", "L1.swp", "L2.swp", "owner.pid"]
    # the two device layer buffers view back as the layer tree
    lp = eng._stream_trees[0]
    assert set(lp) == {"ln_attn", "attn", "ln_mlp", "mlp"}
    assert lp["attn"]["wq"].shape == (32, 32)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_streamed_forward_matches_the_jax_streamed_engine(pair, device, tmp_path):
    toks = _toks(0)
    want = np.asarray(pair.jax(zero=_zero(device, tmp_path / "j")).forward(toks), np.float32)
    eng = pair.port(zero=_zero(device, tmp_path / "p"))
    got = eng.forward(toks).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pair.port().forward(toks).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_streamed_generate_matches_the_jax_streamed_engine(pair, device, tmp_path):
    prompt = np.asarray([[5, 9, 2, 7]], np.int32)
    want = np.asarray(pair.jax(zero=_zero(device, tmp_path / "j")).generate(
        prompt, max_new_tokens=6))
    eng = pair.port(zero=_zero(device, tmp_path / "p"))
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=6), want)
    np.testing.assert_array_equal(pair.port().generate(prompt, max_new_tokens=6), want)


def test_streamed_generate_eos_early_exit(pair):
    eng = pair.port(zero=_zero("cpu"))
    prompt = np.asarray([[5, 9, 2, 7]], np.int32)
    full = eng.generate(prompt, max_new_tokens=6)
    eos = int(full[0, 5])
    cut = eng.generate(prompt, max_new_tokens=6, eos_token_id=eos)
    want = np.asarray(pair.jax(zero=_zero("cpu")).generate(prompt, max_new_tokens=6,
                                                           eos_token_id=eos))
    np.testing.assert_array_equal(cut, want)
    assert cut.shape[1] <= full.shape[1] and eos in cut[0, 4:]


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_streaming_composes_with_int8(device, tmp_path):
    """int8 layers stream as Quantized8 leaves (payload and scales)."""
    p = _Pair(tie_embeddings=True)
    eng = p.port(dtype="int8", zero=_zero(device, tmp_path / "p"))
    lp = eng._stream_trees[1]
    assert isinstance(lp["attn"]["wq"], Quantized8) and lp["attn"]["wq"].q.dtype == torch.int8
    assert lp["attn"]["wq"].scale.dtype == torch.float32
    toks = _toks(1, (1, 8))
    out = eng.forward(toks)
    assert bool(torch.isfinite(out.float()).all())
    # the resident int8 engine on the same weights: the same dequantized blocks
    np.testing.assert_array_equal(out.float().numpy(),
                                  p.port(dtype="int8").forward(toks).float().numpy())
    want = np.asarray(p.jax(dtype="int8", zero=_zero(device, tmp_path / "j")).generate(
        np.asarray([[3, 1, 4]], np.int32), max_new_tokens=5))
    np.testing.assert_array_equal(eng.generate(np.asarray([[3, 1, 4]], np.int32),
                                               max_new_tokens=5), want)


def test_streaming_nvme_requires_path(pair):
    with pytest.raises(ValueError, match="nvme_path"):
        pair.port(zero={"stage": 3, "offload_param": {"device": "nvme"}})


def test_streamed_generate_zero_new_tokens(pair):
    out = pair.port(zero=_zero("cpu")).generate(np.asarray([[5, 9, 2, 7]], np.int32),
                                                max_new_tokens=0)
    assert out.shape == (1, 4)


def test_generate_batch_takes_the_static_path_and_sessions_are_refused(pair):
    eng = pair.port(zero=_zero("cpu"))
    assert not eng._paged_supported()
    prompts = [np.asarray([5, 9, 2, 7], np.int32), np.asarray([1, 2, 3], np.int32)]
    rows = eng.generate_batch(prompts, max_new_tokens=4)
    jeng = pair.jax(zero=_zero("cpu"))
    for p, row in zip(prompts, rows):
        np.testing.assert_array_equal(row, np.asarray(jeng.generate(p[None], max_new_tokens=4))[0])
    with pytest.raises(ValueError, match="weight-streaming"):
        eng.open_serve_session(max_new=4)


def test_streaming_nvme_cleans_up_on_release(pair, tmp_path):
    eng = pair.port(zero=_zero("nvme", tmp_path))
    assert glob.glob(str(tmp_path / "zero_inference_*"))
    eng._swap_cleanup()          # what collection / interpreter exit runs
    del eng
    gc.collect()
    assert not glob.glob(str(tmp_path / "zero_inference_*"))
    # and by collection alone
    eng = pair.port(zero=_zero("nvme", tmp_path))
    del eng
    gc.collect()
    assert not glob.glob(str(tmp_path / "zero_inference_*"))


@pytest.mark.parametrize("extra", [{}, {"dtype": "int8", "quant": {"weight": {"q_groups": 8}}},
                                   {"nvme": True}])
def test_streaming_with_tp_is_refused_as_sharded_serving(pair, extra, tmp_path):
    """The JAX engine streams TP-sharded layers over a mesh; the port has no
    tensor-parallel serving yet, so tp > 1 raises naming its item."""
    extra = dict(extra)
    zero = _zero("nvme", tmp_path) if extra.pop("nvme", False) else _zero("cpu")
    with pytest.raises(NotImplementedError, match="sharded serving"):
        pair.port(tensor_parallel={"tp_size": 2}, zero=zero, **extra)


def test_streaming_refuses_moe_and_post_ln():
    from deepspeed_tpu_torch.models.moe_lm import MoECausalLM, MoEConfig
    moe = MoECausalLM(TransformerConfig(**BASE), MoEConfig(num_experts=2))
    with pytest.raises(NotImplementedError, match="MoE models is not implemented"):
        deepspeed_tpu_torch.init_inference(moe, dtype="fp32", device="cpu", zero=_zero("cpu"))
    post = CausalLM(TransformerConfig(**{**BASE, "norm_position": "post"}))
    with pytest.raises(ValueError, match="pre-LN"):
        deepspeed_tpu_torch.init_inference(post, dtype="fp32", device="cpu", zero=_zero("cpu"))


def test_streamed_forward_with_attention_mask(pair):
    """The mask is the cached blocks' key-side pad bias, as in the JAX
    streamed engine."""
    toks = _toks(7)
    mask = np.ones((2, 10), np.int32)
    mask[0, :3] = 0
    eng = pair.port(zero=_zero("cpu"))
    got = eng.forward(toks, attention_mask=mask).numpy()
    want = np.asarray(pair.jax(zero=_zero("cpu")).forward(toks, attention_mask=mask),
                      np.float32)
    np.testing.assert_allclose(got[0, 3:], want[0, 3:], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    one = eng.forward(toks[0], attention_mask=mask[0]).numpy()
    np.testing.assert_allclose(one[0, 3:], got[0, 3:], rtol=1e-5, atol=1e-5)


def test_streamed_step_double_buffers(pair, tmp_path):
    """Before block i is dispatched, layer i+1's copy is queued and layer
    i+2's NVMe read submitted, one submit outstanding at a time."""
    eng = pair.port(zero=_zero("nvme", tmp_path))
    toks = np.asarray([[1, 2, 3]], np.int32)
    eng.generate(toks, max_new_tokens=1)
    events = []
    submit, finish, put = eng._fetch_submit, eng._fetch_finish, eng._put_layer
    eng._fetch_submit = lambda i: (events.append(("submit", i)), submit(i))[1]
    fin = iter(range(10))
    eng._fetch_finish = lambda h: (events.append(("finish", next(fin))), finish(h))[1]
    eng._put_layer = lambda i, host: (events.append(("put", i)), put(i, host))[1]
    import deepspeed_tpu_torch.models.transformer as T
    real_block = T.cached_block
    blk = iter(range(10))

    def block(*a, **kw):
        events.append(("blk", next(blk)))
        return real_block(*a, **kw)

    T.cached_block = block
    try:
        eng.generate(toks, max_new_tokens=1)
    finally:
        T.cached_block = real_block
    order = {e: i for i, e in enumerate(events)}
    assert order[("put", 1)] < order[("blk", 0)], events
    assert order[("submit", 2)] < order[("blk", 0)], events
    pend = 0
    for kind, _ in events:
        pend += {"submit": 1, "finish": -1}.get(kind, 0)
        assert pend <= 1, events
    assert pend == 0, events


def test_streamed_nvme_sweeps_stale_dirs(pair, tmp_path):
    child = subprocess.Popen(["true"])
    child.wait()                     # reaped: the pid no longer exists
    dead = child.pid
    me_scope, _ = InferenceEngine._owner_marker().rsplit(":", 1)
    stale = tmp_path / "zero_inference_stale"
    stale.mkdir()
    (stale / "owner.pid").write_text(f"{me_scope}:{dead}")
    live = tmp_path / "zero_inference_live"
    live.mkdir()
    (live / "owner.pid").write_text(InferenceEngine._owner_marker())
    unmarked = tmp_path / "zero_inference_old"
    unmarked.mkdir()
    foreign = tmp_path / "zero_inference_foreign"
    foreign.mkdir()
    (foreign / "owner.pid").write_text(f"otherhost:deadbeef:pid:[1]:{dead}")
    eng = pair.port(zero=_zero("nvme", tmp_path))
    assert not stale.exists() and live.exists() and unmarked.exists() and foreign.exists()
    own = [d for d in tmp_path.glob("zero_inference_*/owner.pid")
           if d.read_text() == InferenceEngine._owner_marker() and d.parent != live]
    assert [d.parent for d in own] == [type(tmp_path)(eng._swap_dir)]
