"""Architecture presets (counterpart of ``deepspeed_tpu/models/presets.py``):
the same dims, so a preset names the same model in both packages."""

from __future__ import annotations

from typing import Callable, Dict

from deepspeed_tpu_torch.models.causal_lm import CausalLM
from deepspeed_tpu_torch.models.transformer import TransformerConfig


def gpt2(size: str = "125m", **over) -> CausalLM:
    dims = {
        "125m": dict(n_layer=12, n_head=12, d_model=768),
        "350m": dict(n_layer=24, n_head=16, d_model=1024),
        "774m": dict(n_layer=36, n_head=20, d_model=1280),
        "1.5b": dict(n_layer=48, n_head=25, d_model=1600),
    }[size]
    cfg = TransformerConfig(vocab_size=50257, max_seq=1024, pos_embedding="learned",
                            norm="layernorm", activation="gelu", tie_embeddings=True,
                            attn_bias=True, **dims, **over)
    return CausalLM(cfg)


def gpt2_medium(**over) -> CausalLM:
    return gpt2("350m", **over)


def gpt2_large(**over) -> CausalLM:
    return gpt2("774m", **over)


def gpt2_xl(**over) -> CausalLM:
    return gpt2("1.5b", **over)


def llama_7b(**over) -> CausalLM:
    cfg = TransformerConfig(vocab_size=32000, n_layer=32, n_head=32, d_model=4096, d_ff=11008,
                            max_seq=2048, pos_embedding="rope", norm="rmsnorm",
                            activation="swiglu", tie_embeddings=False, norm_eps=1e-6, **over)
    return CausalLM(cfg)


def llama(size: str = "7b", **over) -> CausalLM:
    dims = {
        "tiny": dict(n_layer=4, n_head=8, d_model=512, d_ff=1408, vocab_size=32000, max_seq=512),
        "7b": dict(n_layer=32, n_head=32, d_model=4096, d_ff=11008, vocab_size=32000, max_seq=2048),
        "13b": dict(n_layer=40, n_head=40, d_model=5120, d_ff=13824, vocab_size=32000, max_seq=2048),
        "70b": dict(n_layer=80, n_head=64, d_model=8192, d_ff=28672, n_kv_head=8,
                    vocab_size=32000, max_seq=4096),
    }[size]
    cfg = TransformerConfig(pos_embedding="rope", norm="rmsnorm", activation="swiglu",
                            tie_embeddings=False, norm_eps=1e-6, **{**dims, **over})
    return CausalLM(cfg)


def bloom(size: str = "560m", **over) -> CausalLM:
    dims = {
        "560m": dict(n_layer=24, n_head=16, d_model=1024),
        "1b7": dict(n_layer=24, n_head=16, d_model=2048),
        "7b1": dict(n_layer=30, n_head=32, d_model=4096),
        "176b": dict(n_layer=70, n_head=112, d_model=14336),
    }[size]
    cfg = TransformerConfig(vocab_size=250880, max_seq=2048, pos_embedding="alibi",
                            norm="layernorm", activation="gelu", tie_embeddings=True,
                            embed_layernorm=True, attn_bias=True, **dims, **over)
    return CausalLM(cfg)


def opt(size: str = "125m", **over) -> CausalLM:
    dims = {
        "125m": dict(n_layer=12, n_head=12, d_model=768),
        "1.3b": dict(n_layer=24, n_head=32, d_model=2048),
        "6.7b": dict(n_layer=32, n_head=32, d_model=4096),
        "13b": dict(n_layer=40, n_head=40, d_model=5120),
        "30b": dict(n_layer=48, n_head=56, d_model=7168),
        "66b": dict(n_layer=64, n_head=72, d_model=9216),
    }[size]
    cfg = TransformerConfig(vocab_size=50272, max_seq=2048, pos_embedding="learned",
                            norm="layernorm", activation="relu", tie_embeddings=True,
                            attn_bias=True, **dims, **over)
    return CausalLM(cfg)


def gpt_neox(size: str = "20b", **over) -> CausalLM:
    dims = {
        "tiny": dict(n_layer=4, n_head=8, d_model=512),
        "20b": dict(n_layer=44, n_head=64, d_model=6144),
    }[size]
    cfg = TransformerConfig(vocab_size=50432, max_seq=2048, pos_embedding="rope",
                            norm="layernorm", activation="gelu", parallel_residual=True,
                            tie_embeddings=False, attn_bias=True, **dims, **over)
    return CausalLM(cfg)


MODEL_PRESETS: Dict[str, Callable] = {
    "gpt2": gpt2,
    "llama": llama,
    "bloom": bloom,
    "opt": opt,
    "gpt_neox": gpt_neox,
}


def get_model(family: str, size: str = None, **over) -> CausalLM:
    fn = MODEL_PRESETS[family]
    return fn(size, **over) if size else fn(**over)
