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
the host masters, and the config's offload sections.

The comparisons run at the JAX file's lr 1e-2. There a handful of the
~50k elements part by more than ``atol`` after 5 steps. Each side's
backward is first held on its own (:func:`_hold_grads`): at every step, the
gradients its optimizer consumed are within ``GRAD_ULPS`` fp32 ulps of an
fp64 recomputation (:func:`_loss64`) at that side's own params, so a
gradient fault at any step fails. Then :func:`_hold_or_explain` shows for
each element outside the limits (at most ``MAX_EXPLAINED`` of them) that
the gap is fp32 rounding that the normalised update (Adam's, Adagrad's)
amplifies: an fp64 replay of the optimizer over each side's own consumed
gradients reproduces that side's value (each optimizer is right, so the
gap is in the gradient sequences), and at the first step, from identical
params, the two sides' gradients of that element differ by no more than
the reference side's own fp32 error against the fp64 gradient leaf. Where the gradients are equal at that step
(the port's device and host optimizers share one backward) the sequences
part only through the two optimizers' fp32 bias corrections, as they part
in the JAX package. :func:`test_offload_comparison_fails_on_a_planted_fault`
plants a clip scaled by 1.001 and a gradient fault from step 2 into the
host side, and the comparison must fail on each."""

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
    # a copy: the JAX host optimizer steps its masters in place, which may
    # be the arrays it was given (the module's fixture)
    return deepspeed_tpu.initialize(model=jparams[0],
                                    model_parameters=jax.tree.map(np.array, jparams[1]),
                                    config=config, mesh=mesh)[0]


def _leaves(engine):
    return jax.tree.leaves(params_to_jax(engine.module.config, engine.state.params))


def _nvme(tmp_path, name="swap"):
    return {"device": "nvme", "nvme_path": str(tmp_path / name)}


def _loss64(params, ids):
    """The tiny Llama's next-token loss (``LLAMA``) in float64 over the
    JAX package's stacked tree: the fp64 recomputation the comparisons'
    gradients are held to."""
    L, H, KV, Hd = params["layers"], LLAMA["n_head"], LLAMA["n_kv_head"], 32
    ids = torch.as_tensor(ids).long()
    B, S = ids.shape
    rms = lambda x, s: x * torch.rsqrt((x * x).mean(-1, keepdim=True) + LLAMA["norm_eps"]) * s
    half = Hd // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]

    def rope(t):
        a, b = t[..., :half], t[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    x = params["embed"]["tokens"][ids]
    causal = torch.ones(S, S, dtype=torch.bool).triu(1)
    for i in range(LLAMA["n_layer"]):
        h = rms(x, L["ln_attn"]["scale"][i])
        q = rope((h @ L["attn"]["wq"][i]).reshape(B, S, H, Hd))
        k = rope((h @ L["attn"]["wk"][i]).reshape(B, S, KV, Hd)).repeat_interleave(H // KV, 2)
        v = (h @ L["attn"]["wv"][i]).reshape(B, S, KV, Hd).repeat_interleave(H // KV, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(Hd)
        p = torch.softmax(s.masked_fill(causal, float("-inf")), -1)
        x = x + torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * Hd) @ L["attn"]["wo"][i]
        h = rms(x, L["ln_mlp"]["scale"][i])
        x = x + (torch.nn.functional.silu(h @ L["mlp"]["w_gate"][i])
                 * (h @ L["mlp"]["w_up"][i])) @ L["mlp"]["w_down"][i]
    logits = rms(x, params["ln_f"]["scale"]) @ params["lm_head"]
    return torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                             ids[:, 1:].reshape(-1))


def _grad64(tree, batch, config):
    """The fp64 gradient of one train_batch (the mean of its micro-batches'
    losses) at ``tree``, by JAX leaf key, with the configured clip applied
    as both engines apply it."""
    flat = {k: torch.tensor(a, dtype=torch.float64, requires_grad=True) for k, a in tree.items()}
    nest = {}
    for key, t in flat.items():
        d = nest
        for part in key.split(".")[:-1]:
            d = d.setdefault(part, {})
        d[key.split(".")[-1]] = t
    micro = config["train_micro_batch_size_per_gpu"]
    ids = batch["input_ids"]
    loss = sum(_loss64(nest, ids[i:i + micro]) for i in range(0, len(ids), micro))
    grads = torch.autograd.grad(loss / (len(ids) // micro), list(flat.values()))
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    coef = min(1.0, config["gradient_clipping"] / (norm + 1e-6))
    return {k: (g * coef).numpy() for k, g in zip(flat, grads)}


class _Consumed:
    """One engine's run, by JAX leaf key (flat, stacked over layers), per
    step: the params before the step (``params_of(engine)``), its batch, and
    the gradients the optimizer consumes: a host optimizer's ``opt.step``
    calls (after its clip), or the device optimizer's ``leaf_update`` calls
    (the port's per-layer leaves, stacked here)."""

    def __init__(self, engine, params_of):
        self.steps, self.params, self.batches = [], [], []
        train_batch = engine.train_batch

        def run(batch):
            self.params.append(params_of(engine))
            self.batches.append(batch)
            return train_batch(batch)
        engine.train_batch = run
        if getattr(engine, "_offload", None) is not None:
            opt = engine._offload.opt
            inner = opt.step

            def step(key, params, grads, *a, **kw):
                self._record(opt.step_count, key, np.array(grads, np.float32).ravel())
                return inner(key, params, grads, *a, **kw)
            opt.step = step
        else:
            from deepspeed_tpu_torch.runtime.utils import jax_leaves
            self._key = {n: ".".join(path) for path, ns in jax_leaves(engine._names).items()
                         for n in ns}
            tx, inner = engine.tx, engine.tx.leaf_update

            def leaf_update(state, name, grad, param, lr, sq=None):
                self._record(state.count, self._key[name], grad.detach().numpy().ravel().copy(),
                             append=True)
                return inner(state, name, grad, param, lr, sq=sq)
            tx.leaf_update = leaf_update

    def _record(self, count, key, g, append=False):
        while len(self.steps) < count:
            self.steps.append({})
        d = self.steps[count - 1]
        d[key] = np.concatenate([d[key], g]) if append and key in d else g


GRAD_ULPS = 32      # read: 9-14 over the four comparisons' sides and steps
MAX_EXPLAINED = 16  # read: 5 (device vs host AdamW), 4 (port vs JAX AdamW), 10 (Adagrad)


def _hold_grads(run, config):
    """Every step's consumed gradients of one side within ``GRAD_ULPS``
    fp32 ulps of the leaf's largest of the fp64 gradient at that side's own
    params. Returns the fp64 gradients by step."""
    g64 = []
    for t, (params, batch) in enumerate(zip(run.params, run.batches)):
        g64.append(_grad64(params, batch, config))
        for key, want in g64[-1].items():
            err = np.abs(run.steps[t][key] - want.ravel()).max()
            ulp = np.spacing(np.float32(np.abs(want).max()))
            assert err <= GRAD_ULPS * ulp, ("consumed gradient", t + 1, key, err / ulp)
    return g64


def _adam64(p0, grads, lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
    """AdamW in float64 over one element's consumed gradients."""
    p, m, v = float(p0), 0.0, 0.0
    for t, g in enumerate(grads, 1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p -= lr * ((m / (1 - b1**t)) / (np.sqrt(v / (1 - b2**t)) + eps) + wd * p)
    return p


def _adagrad64(p0, grads, lr=1e-2, eps=1e-10):
    """Adagrad (no weight decay) in float64 over one element's consumed
    gradients."""
    p, h = float(p0), 0.0
    for g in grads:
        h += g * g
        p -= lr * g / (np.sqrt(h) + eps)
    return p


def _hold_or_explain(got, want, got_run, want_run, want64, replay=_adam64):
    """``got`` against ``want`` (JAX-layout leaves by key) at RTOL / ATOL.
    Each element outside them must be explained as rounding (the module
    docstring): the fp64 replays (``replay``) of both sides' consumed
    gradients land within ATOL / 10 of each side, and at step 1 the two sides' gradients
    of the element differ by no more than ``want``'s side's largest fp32
    error against its fp64 gradient ``want64[0]`` over the element's leaf.
    At most ``MAX_EXPLAINED`` elements may need it."""
    explained = 0
    for key, a in want.items():
        b = got[key]
        bad = np.abs(b - a) > ATOL + RTOL * np.abs(a)
        for flat in np.flatnonzero(bad.ravel()):
            seq = lambda run: [float(s[key][flat]) for s in run.steps]
            p0 = float(want_run.params[0][key].ravel()[flat])
            for run, val in ((got_run, b.ravel()[flat]), (want_run, a.ravel()[flat])):
                assert abs(replay(p0, seq(run)) - val) <= ATOL / 10, (key, flat)
            ref_err = float(np.abs(want_run.steps[0][key] - want64[0][key].ravel()).max())
            gap = abs(got_run.steps[0][key][flat] - want_run.steps[0][key][flat])
            assert gap <= ref_err, (key, flat, gap, ref_err)
            explained += 1
    assert explained <= MAX_EXPLAINED, explained


def _by_key(tree):
    """A tree's leaves by JAX leaf key, copied (the JAX host optimizer
    steps its masters in place, which may be the arrays it was given)."""
    return {".".join(p.key for p in path): np.array(a, copy=True)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_keys(engine):
    return _by_key(params_to_jax(engine.module.config, engine.state.params))


def _device_vs_host(jparams, gas, plant=None):
    """The port's device optimizer against its host optimizer over 5 steps
    of one backward each: the losses within 1e-5 relative, each side's
    gradients held (:func:`_hold_grads`), then the params at the limits or
    explained. ``plant(engine)`` plants a fault into the host side."""
    cfg = _config(gas=gas)
    dev, off = _port(jparams, cfg), _port(jparams, _config({"device": "cpu"}, gas=gas))
    if plant is not None:
        plant(off)
    g_dev, g_off = _Consumed(dev, _port_keys), _Consumed(off, _port_keys)
    for step in range(5):
        b = _batch(cfg, step)
        want, got = float(dev.train_batch(b)), float(off.train_batch(b))
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
    assert off.global_steps == 5 and off._offload.opt.step_count == 5
    dev64 = _hold_grads(g_dev, cfg)
    _hold_grads(g_off, cfg)
    _hold_or_explain(_port_keys(off), _port_keys(dev), g_off, g_dev, dev64)


@pytest.mark.parametrize("gas", [1, 2])
def test_cpu_offload_matches_device_optimizer(jparams, gas):
    _device_vs_host(jparams, gas)


def _clip_off_by_1e3(engine):
    host, coef = engine._offload, engine._offload._clip_coef
    host._clip_coef = lambda grads: coef(grads) * 1.001


def _grads_kept_from_step_2(engine):
    """The previous step's gradients left in the host's slab, as a buffer
    that is not zeroed after a step would leave them."""
    host, step, prev = engine._offload, engine._offload.step, {}

    def kept(grads, lr, out=None):
        for k, g in grads.items():
            if k in prev:
                g.add_(prev[k])
            prev[k] = g.clone()
        return step(grads, lr, out=out)
    host.step = kept


@pytest.mark.parametrize("plant", [_clip_off_by_1e3, _grads_kept_from_step_2],
                         ids=["clip-1.001", "grads-kept-from-step-2"])
def test_offload_comparison_fails_on_a_planted_fault(jparams, plant):
    with pytest.raises(AssertionError):
        _device_vs_host(jparams, 1, plant)


@pytest.mark.parametrize("case", ["adamw-cpu", "adamw-nvme", "adagrad-cpu"])
def test_offload_matches_the_jax_offload_engine(jparams, one_device_mesh, case, tmp_path):
    opt, device = case.split("-")
    off = {"device": "cpu"} if device == "cpu" else _nvme(tmp_path, "p")
    joff = {"device": "cpu"} if device == "cpu" else _nvme(tmp_path, "j")
    cfg = _config(off, gas=2, micro=4, opt={"adamw": "AdamW", "adagrad": "Adagrad"}[opt])
    peng = _port(jparams, cfg)
    jeng = _jax(jparams, _config(joff, gas=2, micro=4, opt=cfg["optimizer"]["type"]),
                one_device_mesh)
    jax_keys = lambda e: _by_key(jax.tree.map(np.asarray, e.state.params))
    g_port, g_jax = _Consumed(peng, _port_keys), _Consumed(jeng, jax_keys)
    for step in range(5):
        b = _batch(cfg, step)
        want, got = float(jeng.train_batch(b)), float(peng.train_batch(b))
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
    jax64 = _hold_grads(g_jax, cfg)
    _hold_grads(g_port, cfg)
    want, got = jax_keys(jeng), _port_keys(peng)
    jsd, psd = jeng._offload.state_dict(), peng._offload.state_dict()
    replay = {"adamw": _adam64, "adagrad": _adagrad64}[opt]
    for g, w in ((got, want), (psd["masters"], jsd["masters"])):
        _hold_or_explain({k: np.asarray(v).reshape(want[k].shape) for k, v in g.items()},
                         {k: np.asarray(v).reshape(want[k].shape) for k, v in w.items()},
                         g_port, g_jax, jax64, replay)
    # the host state is the JAX layout, key for key and shape for shape
    assert set(jsd) == set(psd) and jsd["step"] == psd["step"] == 5
    for group in ("masters", "exp_avg_sq"):
        assert list(jsd[group]) == list(psd[group])
        for k, v in jsd[group].items():
            assert psd[group][k].shape == v.shape
    for k, v in jsd["exp_avg_sq"].items():
        np.testing.assert_allclose(psd["exp_avg_sq"][k], v, rtol=RTOL, atol=ATOL)


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
