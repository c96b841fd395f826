"""``DSUNet`` / ``DSVAE`` (``deepspeed_tpu_torch/models/diffusers_wrappers.py``)
against the JAX package's ``models/diffusers_wrappers.py``.

- The JAX ``test_clip.py`` wrapper cases, as they are.
- ``chip_smoke.py``'s Stable Diffusion denoiser and VAE levels at a small
  width (conv_in, a ResNet block with the time bias, self-attention,
  GEGLU, conv_out) through the port's ``DSUNet`` on the CPU, held within
  ``RTOL`` (fp32) to a JAX twin of the same functions, written here with
  the JAX package's spatial ops, through the JAX ``DSUNet`` / ``DSVAE``.
- The signature and re-capture logic of the CUDA-graph cache, run here
  with the capture injected (a stand-in that runs the function where a
  graph would replay it): one capture per signature; new values, same
  signature, replay; a new shape, dtype or params tree captures again, and
  a new params tree drops the old tree's graphs; a Python-number timestep
  replays one graph; params changed in place are read in place; the default result is a copy,
  ``donate_latents`` writes into the caller's latents; a failed capture
  raises; mixed devices raise; CPU tensors run eagerly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from deepspeed_tpu.models.diffusers_wrappers import DSUNet as JaxDSUNet
from deepspeed_tpu.models.diffusers_wrappers import DSVAE as JaxDSVAE
from deepspeed_tpu.ops.spatial import kernels as jsk
from deepspeed_tpu_torch.models import DSUNet, DSVAE
from deepspeed_tpu_torch.models import diffusers_wrappers as dw

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

RTOL = 1e-5     # fp32, relative to the output's largest value: summation order only
UNET = {**cs.SD_UNET, "channels": 32, "heads": 2, "groups": 8, "ff": 64, "temb": 64,
        "latent": 8}
VAE = {**cs.SD_VAE, "enc_channels": 16, "dec_channels": 32, "groups": 8, "image": 16}


# ------------------------------------------------------------------ #
# the JAX package's test_clip.py cases


def test_diffusers_wrappers():
    def unet_apply(params, latents, t, context):
        return latents * params["s"] + t

    unet = DSUNet(unet_apply)
    p = {"s": torch.tensor(0.5)}
    lat = torch.ones((1, 8, 8, 4))
    out = unet(p, lat, torch.tensor(1.0), None)
    assert float(out[0, 0, 0, 0]) == 1.5

    vae = DSVAE(encode_fn=lambda p, x: x * 2, decode_fn=lambda p, z: z / 2)
    assert float(vae.encode(None, torch.ones(1))[0]) == 2.0
    assert float(vae.decode(None, torch.ones(1))[0]) == 0.5
    with pytest.raises(ValueError, match="encode_fn"):
        DSVAE(decode_fn=lambda p, z: z).encode(None, torch.ones(1))
    with pytest.raises(ValueError, match="decode_fn"):
        DSVAE(encode_fn=lambda p, x: x).decode(None, torch.ones(1))


def test_error_messages_are_the_jax_ones():
    with pytest.raises(ValueError) as want:
        JaxDSVAE(decode_fn=lambda p, z: z).encode(None, jnp.ones(1))
    with pytest.raises(ValueError) as got:
        DSVAE(decode_fn=lambda p, z: z).encode(None, torch.ones(1))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ #
# the denoiser and the VAE levels against a JAX twin


def _jax_params(p):
    """The port's params as JAX arrays: conv weights OIHW -> HWIO."""
    def leaf(t):
        a = t.detach().float().numpy()
        return jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return jax.tree.map(leaf, p, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _j_conv(x, w, b=None):
    y = jax.lax.conv_general_dilated(x, w, (1, 1), ((1, 1), (1, 1)),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     precision=jax.lax.Precision.HIGHEST)
    return y if b is None else jsk.nhwc_bias_add(y, b)


def _j_group_norm(x, w, b, groups, eps):
    N, H, W, C = x.shape
    g = x.reshape(N, H, W, groups, C // groups)
    mean = g.mean(axis=(1, 2, 4), keepdims=True)
    var = ((g - mean) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    return ((g - mean) / jnp.sqrt(var + eps)).reshape(N, H, W, C) * w + b


def _j_layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / jnp.sqrt(var + eps) * w + b


def _j_resnet(x, p, temb_bias, groups, eps):
    h = _j_conv(jax.nn.silu(_j_group_norm(x, p["gn1_w"], p["gn1_b"], groups, eps)), p["conv1_w"])
    h = jsk.nhwc_bias_add(h, p["conv1_b"] if temb_bias is None else p["conv1_b"] + temb_bias)
    h = _j_conv(jax.nn.silu(_j_group_norm(h, p["gn2_w"], p["gn2_b"], groups, eps)), p["conv2_w"])
    return jsk.nhwc_bias_add_add(h, p["conv2_b"], x)


def _j_denoiser(p, latents, timestep, context=None, width=UNET):
    C, G, eps, heads = width["channels"], width["groups"], width["eps"], width["heads"]
    half = C // 2
    freqs = jnp.exp(-np.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / half)
    arg = timestep.reshape(1) * freqs
    emb = jnp.concatenate([jnp.cos(arg), jnp.sin(arg)])
    temb = jax.nn.silu(emb @ p["time_w1"] + p["time_b1"]) @ p["time_w2"] + p["time_b2"]
    temb_bias = jax.nn.silu(temb) @ p["res"]["temb_w"] + p["res"]["temb_b"]
    h = jsk.nhwc_bias_add(_j_conv(latents, p["conv_in_w"]), p["conv_in_b"])
    h = _j_resnet(h, p["res"], temb_bias, G, eps)
    a = p["attn"]
    N, H, W, _ = h.shape
    S = H * W
    x = _j_group_norm(h, a["gn_w"], a["gn_b"], G, 1e-6).reshape(N, S, C)
    x = jsk.nhwc_bias_add(x @ a["proj_in_w"], a["proj_in_b"])
    n = _j_layer_norm(x, a["ln1_w"], a["ln1_b"], 1e-5)
    q, k, v = ((n @ a[w]).reshape(N, S, heads, C // heads) for w in ("wq", "wk", "wv"))
    s = jnp.einsum("nqhd,nkhd->nhqk", q, k) / np.sqrt(C // heads)
    o = jnp.einsum("nhqk,nkhd->nqhd", jax.nn.softmax(s, axis=-1), v).reshape(N, S, C)
    x = jsk.nhwc_bias_add_add(o @ a["wo"], a["bo"], x)
    n = _j_layer_norm(x, a["ln3_w"], a["ln3_b"], 1e-5)
    u, gate = jnp.split(jsk.nhwc_bias_add(n @ a["ff_w"], a["ff_b"]), 2, axis=-1)
    x = jsk.nhwc_bias_add_add((u * jax.nn.gelu(gate, approximate=False)) @ a["ff2_w"],
                              a["ff2_b"], x)
    h = jsk.nhwc_bias_add_add(x @ a["proj_out_w"], a["proj_out_b"], h.reshape(N, S, C))
    h = jax.nn.silu(_j_group_norm(h.reshape(N, H, W, C), p["out_gn_w"], p["out_gn_b"], G, eps))
    return _j_conv(h, p["conv_out_w"], p["conv_out_b"])


def _j_vae_level(p, x, width=VAE):
    h = jsk.nhwc_bias_add(_j_conv(x, p["conv_w"]), p["conv_b"])
    return _j_resnet(h, p["res"], None, width["groups"], width["eps"])


def _close(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("step", [0, 1])
def test_denoiser_matches_the_jax_dsunet(step):
    gen = torch.Generator().manual_seed(step)
    p = cs.sd_unet_params(gen, "cpu", torch.float32, UNET)
    r = np.random.default_rng(step)
    lat = r.standard_normal((2, UNET["latent"], UNET["latent"], 4)).astype(np.float32)
    t = np.float32(999.0 - 500 * step)
    got = DSUNet(functools.partial(cs.sd_denoiser, width=UNET))(
        p, torch.from_numpy(lat), torch.tensor(t))
    with jax.default_matmul_precision("highest"):
        want = JaxDSUNet(_j_denoiser)(_jax_params(p), jnp.asarray(lat), jnp.asarray(t))
    _close(got, want)


def test_vae_graphs_match_the_jax_dsvae():
    p = cs.sd_vae_params(torch.Generator().manual_seed(3), "cpu", torch.float32, VAE)
    r = np.random.default_rng(3)
    img = r.standard_normal((1, VAE["image"], VAE["image"], 3)).astype(np.float32)
    z = r.standard_normal((1, 8, 8, VAE["latent"])).astype(np.float32)
    vae = DSVAE(encode_fn=functools.partial(cs.sd_vae_encode, width=VAE),
                decode_fn=functools.partial(cs.sd_vae_decode, width=VAE))
    jp = _jax_params(p)
    jvae = JaxDSVAE(encode_fn=lambda q, x: _j_vae_level(q["encoder"], x),
                    decode_fn=lambda q, x: _j_vae_level(q["decoder"], x))
    with jax.default_matmul_precision("highest"):
        _close(vae.encode(p, torch.from_numpy(img)), jvae.encode(jp, jnp.asarray(img)))
        _close(vae.decode(p, torch.from_numpy(z)), jvae.decode(jp, jnp.asarray(z)))


# ------------------------------------------------------------------ #
# the graph cache, with the capture injected


@pytest.fixture
def graphs(monkeypatch):
    """Every call takes the graph path; a capture runs the function (the
    side-stream warm-up) and keeps its output as the static output; a
    replay runs it again on the static buffers and writes that output in
    place, as a replayed graph writes its buffers."""
    log = {"captures": 0, "runs": 0}

    def capture(run):
        log["captures"] += 1
        run()
        out = run()

        def replay():
            out.copy_(run())
        return replay, out
    monkeypatch.setattr(dw, "uses_graph", lambda device: device is not None)
    monkeypatch.setattr(dw, "capture_graph", capture)
    return log


def _unet_fn(log=None):
    def apply(params, latents, t, context=None):
        if log is not None:
            log["runs"] += 1
        return latents * params["s"] + t
    return apply


def test_one_capture_per_signature(graphs):
    unet = DSUNet(_unet_fn(graphs))
    p = {"s": torch.tensor(2.0)}
    outs = [unet(p, torch.full((1, 4, 4, 4), float(i)), torch.tensor(1.0)) for i in range(3)]
    assert graphs["captures"] == 1 and unet.replays == 3
    assert [float(o[0, 0, 0, 0]) for o in outs] == [1.0, 3.0, 5.0]
    unet(p, torch.ones((2, 4, 4, 4)), torch.tensor(1.0))            # a new shape
    unet(p, torch.ones((1, 4, 4, 4), dtype=torch.float64), torch.tensor(1.0))   # a new dtype
    assert graphs["captures"] == 3 and unet.captures == 3
    unet(p, torch.ones((1, 4, 4, 4)), torch.tensor(7.0))            # the first signature again
    assert graphs["captures"] == 3


def test_new_params_tree_captures_again_in_place_change_does_not(graphs):
    unet = DSUNet(_unet_fn())
    p = {"s": torch.tensor(2.0)}
    lat = torch.ones((1, 4, 4, 4))
    assert float(unet(p, lat, torch.tensor(0.0))[0, 0, 0, 0]) == 2.0
    p["s"].fill_(3.0)            # read in place by the captured graph
    assert float(unet(p, lat, torch.tensor(0.0))[0, 0, 0, 0]) == 3.0
    assert graphs["captures"] == 1
    q = {"s": torch.tensor(5.0)}     # a new tree: never replayed against the old one
    assert float(unet(q, lat, torch.tensor(0.0))[0, 0, 0, 0]) == 5.0
    assert graphs["captures"] == 2


def test_python_arguments_are_part_of_the_signature(graphs):
    """A Python number enters as a 0-dim tensor (its type in the key, its
    value in a static buffer, as ``jax.jit`` traces it); any other Python
    argument enters by value."""
    unet = DSUNet(lambda params, lat, t, context=None: lat * t if context != "neg" else -lat * t)
    lat = torch.ones((1, 2, 2, 4))
    assert float(unet(None, lat, 2.0)[0, 0, 0, 0]) == 2.0
    assert float(unet(None, lat, 3.0)[0, 0, 0, 0]) == 3.0
    assert graphs["captures"] == 1
    assert float(unet(None, lat, 4)[0, 0, 0, 0]) == 4.0        # an int: int64, a new key
    assert float(unet(None, lat, 5.0, "neg")[0, 0, 0, 0]) == -5.0
    assert float(unet(None, lat, 6.0, "neg")[0, 0, 0, 0]) == -6.0
    assert graphs["captures"] == 3


def test_a_python_timestep_loop_replays_one_graph(graphs):
    seen = []

    def apply(params, lat, t, context=None):
        seen.append(type(t))
        return lat * params["s"] + t
    unet = DSUNet(apply)
    p, lat = {"s": torch.tensor(0.5)}, torch.ones((1, 2, 2, 4))
    timesteps = np.linspace(999, 0, 20).tolist()
    outs = [float(unet(p, lat, t)[0, 0, 0, 0]) for t in timesteps]
    assert graphs["captures"] == 1 and unet.replays == 20 and len(unet._graphs.graphs) == 1
    assert outs == [float(torch.tensor(0.5) + torch.tensor(t)) for t in timesteps]
    assert set(seen) == {torch.Tensor}


def test_a_new_params_tree_drops_the_old_graphs(graphs):
    unet = DSUNet(_unet_fn())
    lat = torch.ones((1, 2, 2, 4))
    p = {"s": torch.tensor(2.0)}
    unet(p, lat, torch.tensor(0.0))
    unet(p, torch.ones((2, 2, 2, 4)), torch.tensor(0.0))
    assert len(unet._graphs.graphs) == 2
    q = {"s": torch.tensor(3.0)}
    assert float(unet(q, lat, torch.tensor(0.0))[0, 0, 0, 0]) == 3.0
    assert len(unet._graphs.graphs) == 1 and graphs["captures"] == 3
    assert float(unet(p, lat, torch.tensor(0.0))[0, 0, 0, 0]) == 2.0    # back: captured again
    assert len(unet._graphs.graphs) == 1 and graphs["captures"] == 4


def test_default_result_is_a_copy_donation_writes_latents(graphs):
    unet = DSUNet(_unet_fn())
    p = {"s": torch.tensor(2.0)}
    first = unet(p, torch.ones((1, 2, 2, 4)), torch.tensor(0.0))
    unet(p, torch.full((1, 2, 2, 4), 5.0), torch.tensor(0.0))
    assert float(first[0, 0, 0, 0]) == 2.0          # not overwritten by the next replay
    donor = DSUNet(_unet_fn(), donate_latents=True)
    lat = torch.ones((1, 2, 2, 4))
    out = donor(p, lat, torch.tensor(1.0))
    assert out is lat and float(lat[0, 0, 0, 0]) == 3.0
    bad = DSUNet(lambda params, l, t, c=None: l.sum(-1), donate_latents=True)
    with pytest.raises(ValueError, match="donate_latents"):
        bad(p, torch.ones((1, 2, 2, 4)), torch.tensor(0.0))


def test_vae_keeps_two_graphs(graphs):
    vae = DSVAE(encode_fn=lambda p, x: x * 2, decode_fn=lambda p, z: z / 2)
    x = torch.ones((1, 4, 4, 3))
    for _ in range(2):
        assert float(vae.encode(None, x)[0, 0, 0, 0]) == 2.0
        assert float(vae.decode(None, x)[0, 0, 0, 0]) == 0.5
    assert graphs["captures"] == 2 and vae.replays == 4


def test_a_failed_capture_raises(monkeypatch):
    def broken(run):
        raise RuntimeError("CUDA graph capture failed: a host read")
    monkeypatch.setattr(dw, "uses_graph", lambda device: True)
    monkeypatch.setattr(dw, "capture_graph", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        DSUNet(_unet_fn())({"s": torch.tensor(1.0)}, torch.ones((1, 2, 2, 4)), torch.tensor(0.0))


def test_mixed_devices_raise():
    unet = DSUNet(_unet_fn())
    with pytest.raises(ValueError, match="more than one device"):
        unet({"s": torch.tensor(1.0)}, torch.ones((1, 2, 2, 4), device="meta"), torch.tensor(0.0))


def test_cpu_tensors_run_eagerly():
    log = {"runs": 0}
    unet = DSUNet(_unet_fn(log))
    for _ in range(3):
        unet({"s": torch.tensor(1.0)}, torch.ones((1, 2, 2, 4)), torch.tensor(0.0))
    assert log["runs"] == 3 and unet.captures == 0 and unet.replays == 0


def test_signature_reads_shapes_dtypes_devices_and_param_pointers():
    p = {"w": torch.ones(3)}
    a = dw.signature(p, (torch.ones(2, 3), 1.5, None), {})
    assert a == dw.signature(p, (torch.zeros(2, 3), 1.5, None), {})
    assert a != dw.signature({"w": torch.ones(3)}, (torch.ones(2, 3), 1.5, None), {})
    assert a != dw.signature(p, (torch.ones(3, 2), 1.5, None), {})
    assert a != dw.signature(p, (torch.ones(2, 3, dtype=torch.float64), 1.5, None), {})
    assert a != dw.signature(p, (torch.ones(2, 3), 2.5, None), {})
