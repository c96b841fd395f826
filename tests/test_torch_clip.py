"""The port's CLIP encoders (``deepspeed_tpu_torch/models/clip.py``) against
the JAX package's on the same weights (``params_from_jax``, and
``clip_params_from_jax`` for the two-tower tree): tiny text and vision
towers (2 layers, d 32, 2 heads), with and without projections.

The text tower's hidden states and pooled output under both pooling rules
(the argmax id with eos id 2, the first eos with another id), the vision
tower's (NHWC patchify, class token, ``ln_pre``, pooled class token through
``ln_f``), ``DSClipEncoder``'s two branches, all within ``TOL``; the three
refusals of the engine's generic forward; the two-tower tree across the
packages bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import clip as jclip
from deepspeed_tpu_torch.checkpoint.from_jax import (clip_params_from_jax, clip_params_to_jax,
                                                     params_from_jax)
from deepspeed_tpu_torch.models import clip as pclip

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

TOL = 1e-5
TEXT = dict(vocab_size=64, max_seq=16, n_layer=2, n_head=2, d_model=32, d_ff=64)
VISION = dict(image_size=32, patch_size=8, n_layer=2, n_head=2, d_model=32, d_ff=64)


def _close(got, want):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _text(proj=None, eos=2, seed=0):
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**TEXT, projection_dim=proj, eos_token_id=eos))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    pm = pclip.CLIPTextEncoder(pclip.CLIPTextConfig(**TEXT, projection_dim=proj, eos_token_id=eos))
    return jm, jp, pm, params_from_jax(pm.config, jp)


def _vision(proj=None, seed=1):
    jm = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**VISION, projection_dim=proj))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    pm = pclip.CLIPVisionEncoder(pclip.CLIPVisionConfig(**VISION, projection_dim=proj))
    return jm, jp, pm, params_from_jax(pm.config, jp)


def _prompts(eos_id, lengths=(5, 11, 16)):
    """Rows of ids below 60 ending at ``eos_id`` and padded with 63 (the
    vocabulary's largest id, CLIP's end-of-text), as CLIP pads."""
    r = np.random.default_rng(3)
    ids = np.full((len(lengths), TEXT["max_seq"]), 63, np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = r.integers(3, 60, size=n)
        ids[i, n - 1] = eos_id
    return ids


def _images(n=2):
    return np.random.default_rng(4).normal(size=(n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("proj", [None, 16])
@pytest.mark.parametrize("eos", [2, 49])
def test_text_tower_matches_jax(proj, eos):
    jm, jp, pm, pp = _text(proj, eos)
    ids = _prompts(63 if eos == 2 else eos)
    h, pooled = pm(pp, torch.as_tensor(ids))
    jh, jpooled = jm(jp, jnp.asarray(ids))
    _close(h, jh)
    _close(pooled, jpooled)
    assert pooled.shape == (3, proj or TEXT["d_model"])
    if eos != 2:         # pooled at the first eos, not at the argmax id (63)
        rows = torch.arange(3)
        first = torch.as_tensor((ids == eos).argmax(-1))
        want = h[rows, first] if proj is None else h[rows, first] @ pp["text_projection"]
        _close(pooled, want.detach())
    _close(pm.forward(pp, ids), jm.forward(jp, jnp.asarray(ids)))


@pytest.mark.parametrize("proj", [None, 16])
def test_vision_tower_matches_jax(proj):
    jm, jp, pm, pp = _vision(proj)
    images = _images()
    h, pooled = pm(pp, torch.as_tensor(images))
    jh, jpooled = jm(jp, jnp.asarray(images))
    assert h.shape == (2, 17, VISION["d_model"])
    _close(h, jh)
    _close(pooled, jpooled)


def test_ds_clip_encoder_matches_jax_and_crosses_bit_for_bit():
    jt, jtp, pt, _ = _text(16)
    jv, jvp, pv, _ = _vision(16)
    jenc, penc = jclip.DSClipEncoder(jt, jv), pclip.DSClipEncoder(pt, pv)
    tree = {"text": jtp, "vision": jvp, "logit_scale": np.asarray(2.6592, np.float32)}
    pp = clip_params_from_jax(penc, tree)
    ids, images = _prompts(63), _images()
    for got, want in zip(penc.encode_text(pp["text"], torch.as_tensor(ids)),
                         jenc.encode_text(tree["text"], jnp.asarray(ids))):
        _close(got, want)
    for got, want in zip(penc.encode_image(pp["vision"], torch.as_tensor(images)),
                         jenc.encode_image(tree["vision"], jnp.asarray(images))):
        _close(got, want)
    back = clip_params_to_jax(penc, pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no vision encoder"):
        pclip.DSClipEncoder(pt).encode_image(pp["vision"], images)


def test_generic_forward_refusals_match_jax():
    jt, jtp, pt, ptp = _text()
    jv, jvp, pv, pvp = _vision()
    ids = _prompts(63)
    mask = np.ones_like(ids)
    cases = [(lambda: pt.forward(ptp, ids, mask), lambda: jt.forward(jtp, ids, mask)),
             (lambda: pv.forward(pvp, ids), lambda: jv.forward(jvp, ids)),
             (lambda: pclip.DSClipEncoder(pt, pv).forward({}, ids),
              lambda: jclip.DSClipEncoder(jt, jv).forward({}, ids))]
    for port, jax_fn in cases:
        with pytest.raises(ValueError) as err:
            port()
        with pytest.raises(ValueError) as jerr:
            jax_fn()
        assert str(err.value) == str(jerr.value)
