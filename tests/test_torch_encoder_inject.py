"""HF encoder checkpoints through the port's loader (``module_inject/``:
``BertPolicy``, ``DistilBertPolicy``, ``CLIPPolicy`` and the
``build_model`` hook) against the JAX package's loader on the same files.

Tiny seeded ``transformers`` models written by
``tests/unit/hf_fixtures.save_hf``: ``BertForMaskedLM``, ``BertModel``
(headless, with its pooler), a relu-head ``BertForMaskedLM``,
``DistilBertForMaskedLM``, ``CLIPModel``, ``CLIPTextModelWithProjection``
and ``CLIPVisionModel``. For each, the port builds the JAX loader's model
class with its configs, every carried leaf is bit-equal to
``params_from_jax`` of the JAX loader's fp32 tree, and the served outputs
(the fill-mask logits or hidden states through ``init_inference(path)``,
the CLIP features through ``encode_text`` / ``encode_image``) agree with
the JAX model's within ``TOL``. An encoder checkpoint refuses generation,
and ``dscli serve`` on one fails with the engine's ``ValueError``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import deepspeed_tpu.comm as jdist  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu_torch.checkpoint.from_jax import (clip_params_from_jax,  # noqa: E402
                                                     params_from_jax)
from deepspeed_tpu_torch.module_inject import load_hf_checkpoint  # noqa: E402
from tests.unit.hf_fixtures import save_hf  # noqa: E402

TOL = 1e-5
_BERT = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64, max_position_embeddings=32)
_TEXT = dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=16, bos_token_id=1, eos_token_id=2)
_VISION = dict(image_size=8, patch_size=4, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4)


@pytest.fixture(autouse=True)
def no_mesh():
    jdist.set_mesh(None)
    yield


def _hf(kind):
    T = transformers
    cases = {
        "bert_mlm": lambda: (T.BertConfig(**_BERT), T.BertForMaskedLM),
        "bert_headless": lambda: (T.BertConfig(**_BERT), T.BertModel),
        "bert_relu_head": lambda: (T.BertConfig(**_BERT, hidden_act="relu"), T.BertForMaskedLM),
        "distilbert_mlm": lambda: (T.DistilBertConfig(vocab_size=96, dim=32, n_layers=2,
                                                      n_heads=2, hidden_dim=64,
                                                      max_position_embeddings=32),
                                   T.DistilBertForMaskedLM),
        "clip": lambda: (T.CLIPConfig(projection_dim=24, text_config=_TEXT,
                                      vision_config=_VISION), T.CLIPModel),
        "clip_text_proj": lambda: (T.CLIPTextConfig(**_TEXT, projection_dim=24),
                                   T.CLIPTextModelWithProjection),
        "clip_vision": lambda: (T.CLIPVisionConfig(**_VISION), T.CLIPVisionModel),
    }
    cfg, cls = cases[kind]()
    torch.manual_seed(sorted(cases).index(kind))
    return cls(cfg), cfg


def _tokens(vocab=96, S=16, seed=0):
    tok = np.random.default_rng(seed).integers(3, vocab - 1, size=(2, S)).astype(np.int32)
    tok[:, -1] = vocab - 1          # CLIP's legacy pooling: the largest id last
    return tok


@pytest.mark.parametrize("kind", ["bert_mlm", "bert_headless", "bert_relu_head",
                                  "distilbert_mlm", "clip", "clip_text_proj", "clip_vision"])
def test_encoder_checkpoint_loads_like_jax(kind, tmp_path):
    hf, cfg = _hf(kind)
    d = save_hf(hf, cfg, tmp_path)
    model, params = load_hf_checkpoint(d)
    jmodel, jparams = jax_load(d)
    assert type(model).__name__ == type(jmodel).__name__
    jtree = jax.tree.map(np.asarray, jparams)
    if kind == "clip":
        want = clip_params_from_jax(model, jtree)
        for tower in ("text", "vision"):
            assert dataclasses.asdict(getattr(model, tower).config) == \
                dataclasses.asdict(getattr(jmodel, tower).config)
    else:
        want = params_from_jax(model.config, jtree)
        assert dataclasses.asdict(model.config) == dataclasses.asdict(jmodel.config)
    got_named, want_named = dict(params.named_parameters()), dict(want.named_parameters())
    assert set(got_named) == set(want_named)
    for n, t in want_named.items():
        assert torch.equal(got_named[n], t), n

    if kind.startswith(("bert", "distilbert")):
        assert model.with_mlm_head == (kind != "bert_headless")
        tok = _tokens()
        mask = (np.arange(16)[None] < np.array([16, 9])[:, None]).astype(np.int32)
        engine = deepspeed_tpu_torch.init_inference(d, dtype="fp32", device="cpu")
        assert type(engine.module).__name__ == type(jmodel).__name__
        for m in (None, mask):
            got = engine.forward(tok, attention_mask=m)
            want_out = jmodel.forward(jparams, jnp.asarray(tok),
                                      None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
        h, pooled = model(params, torch.as_tensor(tok))
        jh, jpooled = jmodel(jparams, jnp.asarray(tok))
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=TOL, atol=TOL)
        with pytest.raises(ValueError, match="is an encoder"):
            engine.generate(tok[:1, :4], max_new_tokens=2)
        # the model given, the checkpoint through the config
        given = deepspeed_tpu_torch.init_inference(model, checkpoint=d, dtype="fp32",
                                                   device="cpu")
        assert given.module is model
        assert torch.equal(given.forward(tok, attention_mask=mask),
                           engine.forward(tok, attention_mask=mask))
        return
    tok = _tokens(vocab=99)
    img = np.random.default_rng(1).normal(size=(2, 8, 8, 3)).astype(np.float32)
    if kind == "clip":
        pairs = [(model.encode_text(params["text"], tok),
                  jmodel.encode_text(jparams["text"], jnp.asarray(tok))),
                 (model.encode_image(params["vision"], img),
                  jmodel.encode_image(jparams["vision"], jnp.asarray(img)))]
        assert "logit_scale" in got_named
    elif kind == "clip_text_proj":
        pairs = [(model(params, tok), jmodel(jparams, jnp.asarray(tok)))]
        assert "text_projection" in got_named
        # a text tower serves the engine's generic forward: its hidden states
        engine = deepspeed_tpu_torch.init_inference(d, dtype="fp32", device="cpu")
        assert torch.equal(engine.forward(tok), model(params, tok)[0])
    else:
        pairs = [(model(params, img), jmodel(jparams, jnp.asarray(img)))]
        engine = deepspeed_tpu_torch.init_inference(d, dtype="fp32", device="cpu")
        with pytest.raises(ValueError, match="serves via __call__"):
            engine.forward(tok)
    for got, want_out in pairs:
        for a, b in zip(got, want_out):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_bert_checkpoint_is_refused_by_the_serving_loop(tmp_path):
    """``dscli serve --checkpoint`` on an encoder: the engine loads the
    checkpoint's BertModel and the serving session refuses it with the
    encoder ``ValueError``, not a not-ported error."""
    from deepspeed_tpu_torch import cli
    from deepspeed_tpu_torch.inference.serve import serve_main
    hf, cfg = _hf("bert_mlm")
    d = save_hf(hf, cfg, tmp_path)
    argv = ["--device", "cpu", "--dtype", "fp32", "--checkpoint", d, "--port", "0"]
    with pytest.raises(ValueError, match="BertModel is an encoder; a serving session"):
        serve_main(argv)
    assert cli.main(["serve"] + argv) == 2
