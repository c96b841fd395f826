"""HF checkpoint ingestion in the port (``module_inject/``: the policies,
the streaming loader, the port's own safetensors reader) against the JAX
package's loader on the same files.

Each causal-LM case of the JAX package's ``TestHFPolicies`` (tiny
``transformers`` models written by ``tests/unit/hf_fixtures.save_hf``):
the port's tree is bit-equal, leaf for leaf, to ``params_from_jax`` of the
JAX loader's fp32 tree, its config equals the JAX policy's field for field,
and its fp32 logits are within ``TOL`` absolute of the JAX model's (the
JAX package's own tests hold its loader to ``transformers``). Also: the
policies' rejections raise the JAX package's exception types; bert,
distilbert and clip build the JAX policy's configs and model classes
(``tests/test_torch_encoder_inject.py`` holds their weights and outputs);
sharded indexes over
safetensors and torch ``.bin``; a shard missing from disk or from the index
raises; the reader equals ``safetensors.numpy.load_file`` bit for bit for
every dtype it takes and refuses the others by name; a bf16 load equals the
fp32 load cast; ``init_inference(path)`` and ``config.checkpoint`` generate
the JAX engine's greedy tokens."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

import dataclasses  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu.comm as jdist  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu.module_inject.policies import policy_for as jax_policy_for  # noqa: E402
from deepspeed_tpu_torch.checkpoint import _safetensors  # noqa: E402
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax  # noqa: E402
from deepspeed_tpu_torch.checkpoint.state_dict_factory import load_state_dict_file  # noqa: E402
from deepspeed_tpu_torch.module_inject import POLICIES, load_hf_checkpoint, policy_for  # noqa: E402
from tests.unit.hf_fixtures import save_hf  # noqa: E402

TOL = 1e-4          # fp32 logits, absolute (tests/test_torch_model.py)


@pytest.fixture(autouse=True)
def no_mesh():
    jdist.set_mesh(None)
    yield


def _hf(kind):
    """A tiny seeded transformers model of each JAX TestHFPolicies case, and
    the length of the token rows its logits are compared on."""
    T = transformers
    cases = {
        "gpt2": lambda: (T.GPT2Config(vocab_size=96, n_positions=32, n_embd=32, n_layer=2,
                                      n_head=2), T.GPT2LMHeadModel, 24),
        "llama": lambda: (T.LlamaConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=2, num_key_value_heads=2,
                                        intermediate_size=64, max_position_embeddings=32,
                                        tie_word_embeddings=False), T.LlamaForCausalLM, 24),
        "llama_gqa": lambda: (T.LlamaConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                                            num_attention_heads=4, num_key_value_heads=2,
                                            intermediate_size=64, max_position_embeddings=32,
                                            tie_word_embeddings=False), T.LlamaForCausalLM, 24),
        "bloom": lambda: (T.BloomConfig(vocab_size=96, hidden_size=32, n_layer=2, n_head=4),
                          T.BloomForCausalLM, 24),
        "opt": lambda: (T.OPTConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                    num_attention_heads=2, ffn_dim=64,
                                    max_position_embeddings=32, word_embed_proj_dim=32),
                        T.OPTForCausalLM, 24),
        "gpt_neox": lambda: (T.GPTNeoXConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                             num_attention_heads=2, intermediate_size=64,
                                             max_position_embeddings=32, rotary_pct=1.0,
                                             use_parallel_residual=True),
                             T.GPTNeoXForCausalLM, 24),
        "gpt_neox_partial_rotary": lambda: (
            T.GPTNeoXConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=64,
                            max_position_embeddings=32, rotary_pct=0.5,
                            use_parallel_residual=True), T.GPTNeoXForCausalLM, 24),
        "gptj": lambda: (T.GPTJConfig(vocab_size=96, n_embd=32, n_layer=2, n_head=2, n_inner=64,
                                      n_positions=32, rotary_dim=8), T.GPTJForCausalLM, 24),
        "gpt_neo_global": lambda: (T.GPTNeoConfig(vocab_size=96, hidden_size=32, num_layers=2,
                                                  num_heads=4, max_position_embeddings=32,
                                                  attention_types=[[["global"], 2]],
                                                  intermediate_size=64),
                                   T.GPTNeoForCausalLM, 24),
        "gpt_neo_local": lambda: (T.GPTNeoConfig(vocab_size=96, hidden_size=32, num_layers=2,
                                                 num_heads=4, max_position_embeddings=64,
                                                 window_size=24,
                                                 attention_types=[[["global", "local"], 1]],
                                                 intermediate_size=64),
                                  T.GPTNeoForCausalLM, 20),
    }
    cfg, cls, seq = cases[kind]()
    torch.manual_seed(sorted(cases).index(kind))
    return cls(cfg), cfg, seq


CASES = ("gpt2", "llama", "llama_gqa", "bloom", "opt", "gpt_neox", "gpt_neox_partial_rotary",
         "gptj", "gpt_neo_global", "gpt_neo_local")


class _Loaded:
    """One case's checkpoint directory, loaded by both packages."""

    def __init__(self, kind, d):
        self.hf, self.hf_cfg, self.seq = _hf(kind)
        self.dir = save_hf(self.hf, self.hf_cfg, d)
        jdist.set_mesh(None)
        self.jmodel, jtree = jax_load(self.dir)
        self.jtree = jax.tree.map(np.asarray, jtree)
        self.pmodel, self.ptree = load_hf_checkpoint(self.dir)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _Loaded(kind, tmp_path_factory.mktemp(kind))
        return cache[kind]
    return get


def _named(tree):
    return dict(tree.named_parameters())


@pytest.mark.parametrize("kind", CASES)
def test_tree_is_the_jax_loaders_bit_for_bit(loaded, kind):
    c = loaded(kind)
    assert dataclasses.asdict(c.pmodel.config) == dataclasses.asdict(c.jmodel.config)
    want = _named(params_from_jax(c.pmodel.config, c.jtree))
    got = _named(c.ptree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], w), name


@pytest.mark.parametrize("kind", CASES)
def test_logits_match_the_jax_model(loaded, kind):
    c = loaded(kind)
    tok = np.random.default_rng(0).integers(0, c.hf_cfg.vocab_size,
                                            size=(2, c.seq)).astype(np.int64)
    jmodel = type(c.jmodel)(dataclasses.replace(c.jmodel.config, attention_backend="xla"))
    want = np.asarray(jmodel.forward(jax.tree.map(jnp.asarray, c.jtree),
                                     jnp.asarray(tok.astype(np.int32))), np.float32)
    with torch.no_grad():
        got = c.pmodel.forward(c.ptree, torch.from_numpy(tok)).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_gpt_neo_local_is_capped_to_the_window(loaded):
    c = loaded("gpt_neo_local")
    assert c.pmodel.config.max_seq == 24 and c.pmodel.config.attn_scale == 1.0
    assert c.ptree["embed"]["positions"].shape == (24, 32)
    model, _ = load_hf_checkpoint(c.dir, config_overrides={"attention_backend": "xla"})
    assert model.config == dataclasses.replace(c.pmodel.config, attention_backend="xla")


def test_gpt2_conv1d_weights_are_not_transposed(loaded):
    """GPT-2's Conv1D weights are already [in, out]: c_fc's [D, 4D] lands
    as it is (a transpose would flip the shape)."""
    c = loaded("gpt2")
    w = c.hf.transformer.h[0].mlp.c_fc.weight.detach()
    assert torch.equal(c.ptree["layers"][0]["mlp"]["w_up"], w)


def _raises_like_jax(fn_port, fn_jax):
    """Both raise, the same exception type; returns the port's."""
    with pytest.raises(Exception) as jerr:
        fn_jax()
    with pytest.raises(type(jerr.value)) as perr:
        fn_port()
    assert type(perr.value) is type(jerr.value)
    return perr.value


@pytest.mark.parametrize("model_type,hf,match", [
    ("opt", dict(vocab_size=96, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                 ffn_dim=64, max_position_embeddings=32, do_layer_norm_before=False),
     "do_layer_norm_before"),
    ("opt", dict(vocab_size=96, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                 ffn_dim=64, max_position_embeddings=32, _remove_final_layer_norm=True),
     "_remove_final_layer_norm"),
    ("llama", dict(vocab_size=96, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=64, rope_scaling={"rope_type": "llama3", "factor": 8.0}),
     "rope_scaling"),
    ("gpt_neox", dict(vocab_size=96, hidden_size=36, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=64, max_position_embeddings=32, rotary_pct=1 / 6),
     "odd rotary dim"),
    ("gpt_neo", dict(vocab_size=96, hidden_size=32, num_layers=1, num_heads=2,
                     activation_function="silu"), "activation_function"),
])
def test_policy_rejections_raise_the_jax_types(model_type, hf, match):
    err = _raises_like_jax(lambda: policy_for(model_type).zoo_config(hf),
                           lambda: jax_policy_for(model_type).zoo_config(hf))
    assert match in str(err)


def test_rope_spellings_and_neox_theta_field_names():
    hf = dict(vocab_size=96, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=64, max_position_embeddings=32)
    for scaling in ({"rope_type": "default"}, {"type": "linear", "factor": 1.0}):
        got = policy_for("llama").zoo_config({**hf, "rope_scaling": scaling})
        want = jax_policy_for("llama").zoo_config({**hf, "rope_scaling": scaling})
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for over, theta in (({"rope_theta": 500000.0}, 500000.0),
                        ({"rotary_emb_base": 20000.0}, 20000.0)):
        assert policy_for("gpt_neox").zoo_config({**hf, **over}).rope_theta == theta


def test_unknown_architecture_raises_like_jax(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "mamba"}, f)
    from safetensors.numpy import save_file
    save_file({"x": np.zeros(1, np.float32)}, str(tmp_path / "model.safetensors"))
    err = _raises_like_jax(lambda: load_hf_checkpoint(str(tmp_path)),
                           lambda: jax_load(str(tmp_path)))
    assert "no ingestion policy" in str(err)


_TEXT = {"vocab_size": 64, "max_position_embeddings": 16, "num_hidden_layers": 2,
         "num_attention_heads": 2, "hidden_size": 32, "intermediate_size": 64,
         "hidden_act": "quick_gelu", "eos_token_id": 2}
_VISION = {"image_size": 32, "patch_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
           "hidden_size": 32, "intermediate_size": 64, "hidden_act": "quick_gelu"}
_TOWER = {"embed": {}, "layers": [], "text_projection": 0}
_VTOWER = {"patch_embed": 0, "layers": [], "visual_projection": 0}
_ENCODERS = {
    "bert": ({"vocab_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
              "hidden_size": 32, "intermediate_size": 64, "max_position_embeddings": 64,
              "hidden_act": "gelu", "layer_norm_eps": 1e-12, "type_vocab_size": 2},
             {"mlm": {}}),
    "distilbert": ({"vocab_size": 64, "n_layers": 2, "n_heads": 2, "dim": 32,
                    "hidden_dim": 64, "max_position_embeddings": 64, "activation": "relu"},
                   {}),
    "clip": ({"text_config": _TEXT, "vision_config": _VISION, "projection_dim": 16},
             {"text": _TOWER, "vision": _VTOWER}),
    "clip_text_model": (_TEXT, _TOWER),
    "clip_vision_model": (_VISION, _VTOWER),
}


@pytest.mark.parametrize("model_type,item", [
    ("bert", "BertModel"), ("distilbert", "BertModel"), ("clip", "DSClipEncoder"),
    ("clip_text_model", "CLIPTextEncoder"), ("clip_vision_model", "CLIPVisionEncoder")])
def test_encoder_families_raise_naming_their_item(model_type, item):
    """The encoder families the port once refused: the policy's config
    equals the JAX policy's field for field, and its model is the JAX
    policy's model class, built with the same configs."""
    hf, tree = _ENCODERS[model_type]
    assert model_type in POLICIES
    pol, jpol = policy_for(model_type), jax_policy_for(model_type)
    cfg, jcfg = pol.zoo_config(hf), jpol.zoo_config(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model, jmodel = pol.build_model(cfg, hf, tree), jpol.build_model(jcfg, hf, tree)
    assert type(model).__name__ == type(jmodel).__name__ == item
    towers = [(model.text, jmodel.text), (model.vision, jmodel.vision)] \
        if item == "DSClipEncoder" else [(model, jmodel)]
    for m, jm in towers:
        assert dataclasses.asdict(m.config) == dataclasses.asdict(jm.config)
        assert dataclasses.asdict(m.zoo_cfg) == dataclasses.asdict(jm.zoo_cfg)
    if item == "BertModel":
        assert model.with_mlm_head == jmodel.with_mlm_head == (model_type == "bert")


def _shard(d_src, d_dst, fmt):
    """The single-file checkpoint of ``d_src`` split over two shard files
    and an index (safetensors, or torch .bin)."""
    from safetensors.torch import load_file
    sd = load_file(os.path.join(d_src, "model.safetensors"))
    names = sorted(sd)
    half = len(names) // 2
    ext = "safetensors" if fmt == "safetensors" else "bin"
    stem = "model" if fmt == "safetensors" else "pytorch_model"
    files = [f"{stem}-0000{i}-of-00002.{ext}" for i in (1, 2)]
    parts = [{n: sd[n] for n in names[:half]}, {n: sd[n] for n in names[half:]}]
    for fname, part in zip(files, parts):
        if fmt == "safetensors":
            from safetensors.torch import save_file
            save_file(part, os.path.join(d_dst, fname))
        else:
            torch.save(part, os.path.join(d_dst, fname))
    index = {"weight_map": {n: files[0] if i < half else files[1] for i, n in enumerate(names)}}
    idx = "model.safetensors.index.json" if fmt == "safetensors" else "pytorch_model.bin.index.json"
    with open(os.path.join(d_dst, idx), "w") as f:
        json.dump(index, f)
    with open(os.path.join(d_src, "config.json")) as f, \
            open(os.path.join(d_dst, "config.json"), "w") as g:
        g.write(f.read())
    return files, idx


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_sharded_index_streams_to_the_single_file_tree(loaded, tmp_path, fmt):
    c = loaded("llama_gqa")
    _shard(c.dir, str(tmp_path), fmt)
    _, tree = load_hf_checkpoint(str(tmp_path))
    want = _named(c.ptree)
    got = _named(tree)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    if fmt == "safetensors":   # the JAX loader reads the same index to the same tree
        jdist.set_mesh(None)
        _, jtree = jax_load(str(tmp_path))
        jwant = _named(params_from_jax(c.pmodel.config, jax.tree.map(np.asarray, jtree)))
        assert all(torch.equal(got[n], jwant[n]) for n in jwant)


def test_a_missing_shard_raises(loaded, tmp_path):
    c = loaded("llama_gqa")
    files, idx = _shard(c.dir, str(tmp_path), "safetensors")
    with open(tmp_path / idx) as f:
        index = json.load(f)
    # a shard's entries missing from the index: the policy's first read of them
    dropped = {n: f for n, f in index["weight_map"].items() if f != files[0]}
    with open(tmp_path / idx, "w") as f:
        json.dump({"weight_map": dropped}, f)
    with pytest.raises(KeyError):
        load_hf_checkpoint(str(tmp_path))
    # a shard the index names missing on disk: raised before any read
    with open(tmp_path / idx, "w") as f:
        json.dump(index, f)
    os.remove(tmp_path / files[1])
    with pytest.raises(FileNotFoundError, match=files[1]):
        load_hf_checkpoint(str(tmp_path))


def test_bf16_load_is_the_fp32_load_cast(loaded):
    c = loaded("bloom")
    _, tree = load_hf_checkpoint(c.dir, dtype=torch.bfloat16)
    want = _named(c.ptree)
    for name, t in _named(tree).items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, want[name].to(torch.bfloat16)), name


ALL_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool}


def test_reader_equals_safetensors_numpy_for_every_dtype(tmp_path):
    import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy for safetensors.numpy)
    from safetensors.numpy import load_file
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {}
    for name, dt in ALL_DTYPES.items():
        x = torch.randn((3, 5), generator=g, dtype=torch.float64) * 100
        tensors[name] = (x > 0) if dt == torch.bool else x.to(dt)
    tensors["scalar"] = torch.tensor(1.5, dtype=torch.float32)
    tensors["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    with _safetensors.SafetensorsFile(path) as f:
        assert f.metadata == {"format": "pt"}
        assert sorted(f.keys()) == sorted(want)
        got = {n: f.get(n).clone() for n in f.keys()}
    for name, w in want.items():
        t = got[name]
        assert tuple(t.shape) == w.shape, name
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(), w.view(np.int16)), name
        else:
            assert t.dtype == tensors[name].dtype and np.array_equal(t.numpy(), w), name
    # the dict reader and load_state_dict_file give the same views
    assert all(torch.equal(load_state_dict_file(path)[n], got[n]) for n in got)


def test_reader_refuses_other_dtypes_by_name(tmp_path):
    from safetensors.torch import save_file
    path = str(tmp_path / "f8.safetensors")
    save_file({"w": torch.zeros(4).to(torch.float8_e4m3fn),
               "ok": torch.ones(2)}, path)
    with _safetensors.SafetensorsFile(path) as f:
        assert torch.equal(f.get("ok"), torch.ones(2))
        with pytest.raises(ValueError, match="F8_E4M3"):
            f.get("w")


def test_reader_views_outlive_the_file_object(tmp_path):
    from safetensors.torch import save_file
    path = str(tmp_path / "v.safetensors")
    save_file({"a": torch.arange(6, dtype=torch.float32)}, path)
    views = _safetensors.load_file(path)
    views["a"] += 1          # copy-on-write: the file keeps its bytes
    assert views["a"].tolist() == [1, 2, 3, 4, 5, 6]
    assert _safetensors.load_file(path)["a"].tolist() == [0, 1, 2, 3, 4, 5]


def test_torch_file_with_a_module_wrapper(tmp_path):
    sd = {"w": torch.arange(4.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    torch.save({"module": sd}, tmp_path / "mp_rank_00_model_states.pt")
    got = load_state_dict_file(str(tmp_path / "mp_rank_00_model_states.pt"))
    assert sorted(got) == ["b", "w"] and got["b"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_init_inference_from_a_path_generates_the_jax_engines_tokens(loaded):
    c = loaded("gpt2")
    tok = np.array([[1, 2, 3, 4]], np.int32)
    jdist.set_mesh(None)
    want = np.asarray(deepspeed_tpu.init_inference(c.dir, dtype="fp32").generate(
        tok, max_new_tokens=5))
    eng = deepspeed_tpu_torch.init_inference(c.dir, dtype="fp32", device="cpu")
    assert dataclasses.asdict(eng.module.config) == dataclasses.asdict(c.pmodel.config)
    np.testing.assert_array_equal(eng.generate(tok, max_new_tokens=5), want)
    # config.checkpoint with the model given: the same weights, the same tokens
    eng2 = deepspeed_tpu_torch.init_inference(c.pmodel, checkpoint=c.dir, dtype="fp32",
                                              device="cpu")
    assert eng2.module is c.pmodel
    np.testing.assert_array_equal(eng2.generate(tok, max_new_tokens=5), want)
    # serving from the loaded weights: generate_batch's greedy rows too
    got = eng.generate_batch([tok[0]], max_new_tokens=5)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])


def test_init_inference_bf16_leaves_are_the_fp32_load_cast(loaded):
    c = loaded("llama_gqa")
    eng = deepspeed_tpu_torch.init_inference(c.dir, dtype="bf16", device="cpu")
    want = _named(c.ptree)
    for name, t in _named(eng.params).items():
        assert torch.equal(t, want[name].to(torch.bfloat16)), name
