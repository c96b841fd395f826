"""Per-architecture HF -> port parameter policies (the port's copy of
``deepspeed_tpu/module_inject/policies.py``): each policy knows its
architecture's tensor names, fused-qkv layout and model config.

A policy's ``map_params(get, cfg)`` builds the port's tree
(:class:`~deepspeed_tpu_torch.models.transformer.ParamTree` layout: one
sub-tree per layer under ``"layers"``, the same keys as
``checkpoint/from_jax.py``) from ``get(name)``, which returns the HF tensor
already on its device and in its dtype. Every transform here moves data
without arithmetic, so a tree built in bf16 is bit-equal to one built in
fp32 and then cast. Conventions of the layout:

- linear weights are [in, out] (HF ``nn.Linear`` stores [out, in] and is
  transposed; GPT-2's ``Conv1D`` already stores [in, out]);
- fused query_key_value tensors are de-interleaved with the architecture's
  head layout ([H, 3, Hd] for bloom / neox: a plain reshape would
  interleave q/k/v).

Encoder families (distilbert, bert, clip) need models the port has not
ported yet and raise naming their ROADMAP item."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.utils.not_ported import not_ported

Getter = Callable[[str], torch.Tensor]


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.t().contiguous()


def _layers(cfg: TransformerConfig, layer: Callable[[int], Dict]):
    return [layer(i) for i in range(cfg.n_layer)]


def _prefixed(get: Getter, prefix: str) -> Getter:
    """``get`` that falls back to ``prefix + name`` (files may carry a
    "transformer." prefix)."""
    def g(name):
        try:
            return get(name)
        except KeyError:
            return get(prefix + name)
    return g


def _split_headwise_qkv(w: torch.Tensor, H: int, Hd: int):
    """[3*H*Hd, D] fused with the [H, 3, Hd] output layout (bloom / neox) ->
    three [D, H*Hd] (port orientation)."""
    D = w.shape[1]
    w = w.reshape(H, 3, Hd, D)
    return tuple(w[:, j].reshape(H * Hd, D).t().contiguous() for j in range(3))


def _split_headwise_qkv_bias(b: torch.Tensor, H: int, Hd: int):
    b = b.reshape(H, 3, Hd)
    return tuple(b[:, j].reshape(H * Hd).contiguous() for j in range(3))


def _norm(get: Getter, prefix: str, bias: bool = True) -> Dict[str, torch.Tensor]:
    out = {"scale": get(prefix + ".weight")}
    if bias:
        out["bias"] = get(prefix + ".bias")
    return out


class HFPolicy:
    """Base policy: subclasses define ``model_type``, ``zoo_config`` and
    ``map_params``."""

    model_type: str = ""

    def zoo_config(self, hf: Dict[str, Any]) -> TransformerConfig:
        raise NotImplementedError

    def map_params(self, get: Getter, cfg: TransformerConfig) -> Dict:
        raise NotImplementedError


class GPT2Policy(HFPolicy):
    """HF ``gpt2``. Conv1D weights are already [in, out]; c_attn is [D, 3D]
    fused q|k|v (block concat)."""

    model_type = "gpt2"

    def zoo_config(self, hf):
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["n_layer"], n_head=hf["n_head"],
            d_model=hf["n_embd"], max_seq=hf["n_positions"], pos_embedding="learned",
            norm="layernorm", activation="gelu", tie_embeddings=True, attn_bias=True,
            norm_eps=hf.get("layer_norm_epsilon", 1e-5))

    def map_params(self, raw_get, cfg):
        get = _prefixed(raw_get, "transformer.")

        def layer(i):
            h = f"h.{i}."
            q, k, v = (x.contiguous() for x in
                       torch.tensor_split(get(h + "attn.c_attn.weight"), 3, dim=1))
            bq, bk, bv = (x.contiguous() for x in
                          torch.tensor_split(get(h + "attn.c_attn.bias"), 3, dim=0))
            return {
                "ln_attn": _norm(get, h + "ln_1"),
                "attn": {"wq": q, "wk": k, "wv": v, "bq": bq, "bk": bk, "bv": bv,
                         "wo": get(h + "attn.c_proj.weight"),
                         "bo": get(h + "attn.c_proj.bias")},
                "ln_mlp": _norm(get, h + "ln_2"),
                "mlp": {"w_up": get(h + "mlp.c_fc.weight"), "b_up": get(h + "mlp.c_fc.bias"),
                        "w_down": get(h + "mlp.c_proj.weight"),
                        "b_down": get(h + "mlp.c_proj.bias")},
            }
        return {"embed": {"tokens": get("wte.weight"), "positions": get("wpe.weight")},
                "layers": _layers(cfg, layer), "ln_f": _norm(get, "ln_f")}


class LlamaPolicy(HFPolicy):
    """HF ``llama``. nn.Linear weights [out, in] -> transpose; separate
    q/k/v; GQA via num_key_value_heads."""

    model_type = "llama"

    def zoo_config(self, hf):
        scaling = hf.get("rope_scaling")
        if scaling is not None:
            # configs can spell plain rope explicitly: rope_type/type
            # "default", or linear with factor 1.0 -- those are no-ops
            kind = scaling.get("rope_type", scaling.get("type", "default"))
            noop = kind == "default" or (kind == "linear"
                                         and float(scaling.get("factor", 1.0)) == 1.0)
            if not noop:
                # e.g. Llama-3.1 llama3 / longrope scaling: loading it as plain
                # rope would give wrong logits at long positions
                raise NotImplementedError(
                    f"llama rope_scaling={scaling!r}: scaled rope variants "
                    "are not represented in the zoo transformer")
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"], d_model=hf["hidden_size"],
            d_ff=hf["intermediate_size"], max_seq=hf.get("max_position_embeddings", 2048),
            n_kv_head=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            pos_embedding="rope", norm="rmsnorm", activation="swiglu",
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            norm_eps=hf.get("rms_norm_eps", 1e-6))

    def map_params(self, get, cfg):
        def layer(i):
            p = f"model.layers.{i}."
            a, m = p + "self_attn.", p + "mlp."
            return {
                "ln_attn": _norm(get, p + "input_layernorm", bias=False),
                "attn": {"wq": _t(get(a + "q_proj.weight")), "wk": _t(get(a + "k_proj.weight")),
                         "wv": _t(get(a + "v_proj.weight")), "wo": _t(get(a + "o_proj.weight"))},
                "ln_mlp": _norm(get, p + "post_attention_layernorm", bias=False),
                "mlp": {"w_gate": _t(get(m + "gate_proj.weight")),
                        "w_up": _t(get(m + "up_proj.weight")),
                        "w_down": _t(get(m + "down_proj.weight"))},
            }
        out = {"embed": {"tokens": get("model.embed_tokens.weight")},
               "layers": _layers(cfg, layer), "ln_f": _norm(get, "model.norm", bias=False)}
        if not cfg.tie_embeddings:
            out["lm_head"] = _t(get("lm_head.weight"))
        return out


class BloomPolicy(HFPolicy):
    """HF ``bloom``: alibi positions, word-embeddings layernorm,
    per-head-interleaved fused qkv."""

    model_type = "bloom"

    def zoo_config(self, hf):
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["n_layer"], n_head=hf["n_head"],
            d_model=hf["hidden_size"], max_seq=2048, pos_embedding="alibi",
            norm="layernorm", activation="gelu", tie_embeddings=True,
            embed_layernorm=True, attn_bias=True,
            norm_eps=hf.get("layer_norm_epsilon", 1e-5))

    def map_params(self, raw_get, cfg):
        H, Hd = cfg.n_head, cfg.head_dim
        get = _prefixed(raw_get, "transformer.")

        def layer(i):
            p = f"h.{i}."
            a, m = p + "self_attention.", p + "mlp."
            q, k, v = _split_headwise_qkv(get(a + "query_key_value.weight"), H, Hd)
            bq, bk, bv = _split_headwise_qkv_bias(get(a + "query_key_value.bias"), H, Hd)
            return {
                "ln_attn": _norm(get, p + "input_layernorm"),
                "attn": {"wq": q, "wk": k, "wv": v, "bq": bq, "bk": bk, "bv": bv,
                         "wo": _t(get(a + "dense.weight")), "bo": get(a + "dense.bias")},
                "ln_mlp": _norm(get, p + "post_attention_layernorm"),
                "mlp": {"w_up": _t(get(m + "dense_h_to_4h.weight")),
                        "b_up": get(m + "dense_h_to_4h.bias"),
                        "w_down": _t(get(m + "dense_4h_to_h.weight")),
                        "b_down": get(m + "dense_4h_to_h.bias")},
            }
        return {"embed": {"tokens": get("word_embeddings.weight"),
                          "ln": _norm(get, "word_embeddings_layernorm")},
                "layers": _layers(cfg, layer), "ln_f": _norm(get, "ln_f")}


class OPTPolicy(HFPolicy):
    """HF ``opt``: learned positions with a +2 offset, separate q/k/v with
    biases, relu MLP."""

    model_type = "opt"

    def zoo_config(self, hf):
        if not hf.get("do_layer_norm_before", True):
            # opt-350m style post-LN: the zoo transformer is pre-LN only;
            # loading it anyway would produce silently wrong logits
            raise NotImplementedError(
                "opt do_layer_norm_before=False (post-layernorm variant, e.g. "
                "opt-350m) is not supported by the pre-LN zoo transformer")
        if hf.get("_remove_final_layer_norm", False):
            raise NotImplementedError(
                "opt _remove_final_layer_norm=True checkpoints are not supported")
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"], d_model=hf["hidden_size"],
            d_ff=hf["ffn_dim"], max_seq=hf["max_position_embeddings"],
            pos_embedding="learned", norm="layernorm",
            activation=hf.get("activation_function", "relu"),
            tie_embeddings=True, attn_bias=True)

    def map_params(self, get, cfg):
        def g(n):
            try:
                return get(n)
            except KeyError:
                return get(n.replace("model.decoder.", "decoder."))

        def layer(i):
            p = f"model.decoder.layers.{i}."
            a = p + "self_attn."
            return {
                "ln_attn": _norm(g, p + "self_attn_layer_norm"),
                "attn": {"wq": _t(g(a + "q_proj.weight")), "wk": _t(g(a + "k_proj.weight")),
                         "wv": _t(g(a + "v_proj.weight")),
                         "bq": g(a + "q_proj.bias"), "bk": g(a + "k_proj.bias"),
                         "bv": g(a + "v_proj.bias"),
                         "wo": _t(g(a + "out_proj.weight")), "bo": g(a + "out_proj.bias")},
                "ln_mlp": _norm(g, p + "final_layer_norm"),
                "mlp": {"w_up": _t(g(p + "fc1.weight")), "b_up": g(p + "fc1.bias"),
                        "w_down": _t(g(p + "fc2.weight")), "b_down": g(p + "fc2.bias")},
            }
        # OPT's embed_positions carries a 2-slot offset pad in front
        return {"embed": {"tokens": g("model.decoder.embed_tokens.weight"),
                          "positions": g("model.decoder.embed_positions.weight")[2:].clone()},
                "layers": _layers(cfg, layer),
                "ln_f": _norm(g, "model.decoder.final_layer_norm")}


class GPTNeoXPolicy(HFPolicy):
    """HF ``gpt_neox``: parallel residual, rotary (optionally partial via
    ``rotary_pct``), per-head-interleaved fused qkv with biases."""

    model_type = "gpt_neox"

    def zoo_config(self, hf):
        pct = float(hf.get("rotary_pct", 1.0))
        head_dim = hf["hidden_size"] // hf["num_attention_heads"]
        rope_dim = int(head_dim * pct)
        if pct != 1.0 and rope_dim % 2:
            raise NotImplementedError(
                f"gpt_neox rotary_pct={pct}: odd rotary dim {rope_dim}")
        return TransformerConfig(
            rope_dim=0 if pct == 1.0 else rope_dim,
            vocab_size=hf["vocab_size"], n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"], d_model=hf["hidden_size"],
            d_ff=hf["intermediate_size"], max_seq=hf["max_position_embeddings"],
            pos_embedding="rope", norm="layernorm", activation="gelu",
            parallel_residual=bool(hf.get("use_parallel_residual", True)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)), attn_bias=True,
            # newer HF configs serialize the base as "rope_theta", older as
            # "rotary_emb_base": honor both so the base is never silently lost
            rope_theta=float(hf.get("rotary_emb_base", hf.get("rope_theta", 10000.0))),
            norm_eps=hf.get("layer_norm_eps", 1e-5))

    def map_params(self, get, cfg):
        H, Hd = cfg.n_head, cfg.head_dim

        def layer(i):
            p = f"gpt_neox.layers.{i}."
            a, m = p + "attention.", p + "mlp."
            q, k, v = _split_headwise_qkv(get(a + "query_key_value.weight"), H, Hd)
            bq, bk, bv = _split_headwise_qkv_bias(get(a + "query_key_value.bias"), H, Hd)
            return {
                "ln_attn": _norm(get, p + "input_layernorm"),
                "attn": {"wq": q, "wk": k, "wv": v, "bq": bq, "bk": bk, "bv": bv,
                         "wo": _t(get(a + "dense.weight")), "bo": get(a + "dense.bias")},
                "ln_mlp": _norm(get, p + "post_attention_layernorm"),
                "mlp": {"w_up": _t(get(m + "dense_h_to_4h.weight")),
                        "b_up": get(m + "dense_h_to_4h.bias"),
                        "w_down": _t(get(m + "dense_4h_to_h.weight")),
                        "b_down": get(m + "dense_4h_to_h.bias")},
            }
        out = {"embed": {"tokens": get("gpt_neox.embed_in.weight")},
               "layers": _layers(cfg, layer), "ln_f": _norm(get, "gpt_neox.final_layer_norm")}
        if not cfg.tie_embeddings:
            out["lm_head"] = _t(get("embed_out.weight"))
        return out


class GPTJPolicy(HFPolicy):
    """HF ``gptj``: single-LN parallel residual (attn and mlp both read ln_1:
    ln_attn and ln_mlp carry the same weights), partial INTERLEAVED rotary
    (``rotary_dim``, rotate-every-two pairing), bias-free separate q/k/v,
    untied lm_head WITH bias."""

    model_type = "gptj"

    def zoo_config(self, hf):
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["n_layer"],
            n_head=hf["n_head"], d_model=hf["n_embd"],
            d_ff=hf.get("n_inner") or 4 * hf["n_embd"],
            max_seq=hf.get("n_positions", 2048),
            pos_embedding="rope", norm="layernorm", activation="gelu",
            parallel_residual=True, tie_embeddings=False, attn_bias=False,
            rope_dim=int(hf.get("rotary_dim") or hf["n_embd"] // hf["n_head"]),
            rope_interleaved=True, lm_head_bias=True,
            norm_eps=hf.get("layer_norm_epsilon", 1e-5))

    def map_params(self, raw_get, cfg):
        def get(name):
            try:
                return raw_get(name)
            except KeyError:
                return raw_get(name[len("transformer."):] if name.startswith("transformer.")
                               else "transformer." + name)

        def layer(i):
            p = f"transformer.h.{i}."
            a, m = p + "attn.", p + "mlp."
            ln = _norm(get, p + "ln_1")
            return {
                # GPT-J has ONE pre-LN feeding both branches
                "ln_attn": ln, "ln_mlp": {k: t.clone() for k, t in ln.items()},
                "attn": {"wq": _t(get(a + "q_proj.weight")), "wk": _t(get(a + "k_proj.weight")),
                         "wv": _t(get(a + "v_proj.weight")),
                         "wo": _t(get(a + "out_proj.weight"))},
                "mlp": {"w_up": _t(get(m + "fc_in.weight")), "b_up": get(m + "fc_in.bias"),
                        "w_down": _t(get(m + "fc_out.weight")), "b_down": get(m + "fc_out.bias")},
            }
        return {"embed": {"tokens": get("transformer.wte.weight")},
                "layers": _layers(cfg, layer), "ln_f": _norm(get, "transformer.ln_f"),
                "lm_head": _t(get("lm_head.weight")), "lm_head_bias": get("lm_head.bias")}


class GPTNeoPolicy(HFPolicy):
    """HF ``gpt_neo``: GPT-2-style block with UNSCALED attention
    (attn_scale=1.0), gelu_new MLP, and q/k/v projections without biases
    (out_proj keeps one; the all-or-nothing attn_bias rides with zero q/k/v
    biases).

    Local-attention layers (``attention_types`` containing "local") are
    window-limited at window_size tokens; at sequence lengths <= the window
    local == global attention, so ingestion caps ``max_seq`` to the window
    and the model is exact there. Longer contexts would need the banded
    mask and are rejected by max_seq."""

    model_type = "gpt_neo"

    @staticmethod
    def _has_local(hf) -> bool:
        def leaves(x):
            if isinstance(x, (list, tuple)):
                for e in x:
                    yield from leaves(e)
            else:
                yield x
        return any(leaf == "local" for leaf in leaves(hf.get("attention_types", [])))

    def zoo_config(self, hf):
        max_seq = hf.get("max_position_embeddings", 2048)
        if self._has_local(hf):
            window = int(hf.get("window_size", 256))
            if window < max_seq:
                from deepspeed_tpu_torch.utils.logging import warn_once
                warn_once(
                    f"gpt_neo has local-attention layers: max_seq capped to "
                    f"window_size={window} (local == global there); longer "
                    "contexts need banded attention")
                max_seq = window
        act = {"gelu_new": "gelu", "gelu": "gelu_exact",
               "relu": "relu"}.get(hf.get("activation_function", "gelu_new"))
        if act is None:
            raise ValueError(f"unsupported gpt_neo activation_function "
                             f"{hf.get('activation_function')!r}")
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["num_layers"],
            n_head=hf["num_heads"], d_model=hf["hidden_size"],
            d_ff=hf.get("intermediate_size") or 4 * hf["hidden_size"],
            max_seq=max_seq, pos_embedding="learned", norm="layernorm",
            activation=act, tie_embeddings=True, attn_bias=True,
            attn_scale=1.0, norm_eps=hf.get("layer_norm_epsilon", 1e-5))

    def map_params(self, raw_get, cfg):
        get = _prefixed(raw_get, "transformer.")

        def layer(i):
            p = f"h.{i}."
            a, m = p + "attn.attention.", p + "mlp."
            wq = _t(get(a + "q_proj.weight"))
            zeros = torch.zeros(cfg.d_model, dtype=wq.dtype, device=wq.device)
            return {
                "ln_attn": _norm(get, p + "ln_1"),
                "attn": {"wq": wq, "wk": _t(get(a + "k_proj.weight")),
                         "wv": _t(get(a + "v_proj.weight")), "wo": _t(get(a + "out_proj.weight")),
                         # q/k/v carry no biases in gpt-neo; out_proj does
                         "bq": zeros, "bk": zeros.clone(), "bv": zeros.clone(),
                         "bo": get(a + "out_proj.bias")},
                "ln_mlp": _norm(get, p + "ln_2"),
                "mlp": {"w_up": _t(get(m + "c_fc.weight")), "b_up": get(m + "c_fc.bias"),
                        "w_down": _t(get(m + "c_proj.weight")), "b_down": get(m + "c_proj.bias")},
            }
        return {"embed": {"tokens": get("wte.weight"),
                          "positions": get("wpe.weight")[:cfg.max_seq].clone()},
                "layers": _layers(cfg, layer), "ln_f": _norm(get, "ln_f")}


class _NotPortedPolicy(HFPolicy):
    """An HF family whose model the port has not ported yet: its config
    raises naming the ROADMAP item that brings the model."""

    def __init__(self, model_type: str, item: str):
        self.model_type = model_type
        self._item = item

    def zoo_config(self, hf):
        not_ported(f"HF {self.model_type} checkpoints", self._item)


POLICIES: Dict[str, HFPolicy] = {
    p.model_type: p() for p in (GPT2Policy, LlamaPolicy, BloomPolicy, OPTPolicy,
                                GPTNeoXPolicy, GPTJPolicy, GPTNeoPolicy)
}
for _mt, _item in (("distilbert", "queue 1: models/bert.py"), ("bert", "queue 1: models/bert.py"),
                   ("clip", "queue 1: models/clip.py")):
    POLICIES[_mt] = _NotPortedPolicy(_mt, _item)
# standalone HF tower checkpoints carry their own model_type strings
POLICIES["clip_text_model"] = POLICIES["clip"]
POLICIES["clip_vision_model"] = POLICIES["clip"]


def policy_for(model_type: str) -> HFPolicy:
    try:
        return POLICIES[model_type]
    except KeyError:
        raise ValueError(
            f"no ingestion policy for HF model_type={model_type!r}; "
            f"supported: {sorted(POLICIES)}") from None
