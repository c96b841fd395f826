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

Decoder families load into ``CausalLM``; the encoder families (distilbert,
bert, clip) return their own model from :meth:`HFPolicy.build_model`."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from deepspeed_tpu_torch.models.transformer import TransformerConfig

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
    ``map_params``; the encoder families also override ``build_model``."""

    model_type: str = ""

    def zoo_config(self, hf: Dict[str, Any]) -> TransformerConfig:
        raise NotImplementedError

    def map_params(self, get: Getter, cfg: TransformerConfig) -> Dict:
        raise NotImplementedError

    def build_model(self, cfg: TransformerConfig, hf: Dict[str, Any], params: Dict):
        """The model of the mapped params; None means ``CausalLM(cfg)`` (the
        decoder families)."""
        return None


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


def _linear(get: Getter, name: str):
    """An HF ``nn.Linear``'s weight, transposed to [in, out], and its bias."""
    return _t(get(name + ".weight")), get(name + ".bias")


def _has(get: Getter, name: str) -> bool:
    try:
        get(name)
        return True
    except KeyError:
        return False


def _zeros(like: torch.Tensor, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _encoder_layer(get: Getter, names: Dict[str, str]) -> Dict:
    """One post-LN or pre-LN encoder layer from its HF tensor names (key ->
    HF module name)."""
    out = {"attn": {}, "mlp": {}}
    for key, (group, w, b) in (("q", ("attn", "wq", "bq")), ("k", ("attn", "wk", "bk")),
                               ("v", ("attn", "wv", "bv")), ("o", ("attn", "wo", "bo")),
                               ("up", ("mlp", "w_up", "b_up")),
                               ("down", ("mlp", "w_down", "b_down"))):
        out[group][w], out[group][b] = _linear(get, names[key])
    out["ln_attn"] = _norm(get, names["ln_attn"])
    out["ln_mlp"] = _norm(get, names["ln_mlp"])
    return out


class DistilBertPolicy(HFPolicy):
    """HF ``distilbert``: a BERT encoder without token-type embeddings or
    pooler; the MLM head (vocab_transform, vocab_layer_norm and the tied
    vocab_projector) maps onto ``BertModel``'s mlm block. Serves through
    ``BertModel``'s fill-mask surface."""

    model_type = "distilbert"

    def zoo_config(self, hf):
        act = {"gelu": "gelu_exact", "relu": "relu"}.get(hf.get("activation", "gelu"))
        if act is None:
            raise ValueError(f"unsupported distilbert activation {hf.get('activation')!r}")
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["n_layers"], n_head=hf["n_heads"],
            d_model=hf["dim"], d_ff=hf["hidden_dim"],
            max_seq=hf.get("max_position_embeddings", 512), pos_embedding="learned",
            norm="layernorm", norm_position="post", activation=act, causal=False,
            attn_bias=True, tie_embeddings=True, norm_eps=1e-12)

    def build_model(self, cfg, hf, params):
        from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
        bc = BertConfig(vocab_size=cfg.vocab_size, max_seq=cfg.max_seq, n_layer=cfg.n_layer,
                        n_head=cfg.n_head, d_model=cfg.d_model, d_ff=cfg.d_ff,
                        type_vocab_size=1, norm_eps=1e-12, activation=cfg.activation)
        return BertModel(bc, with_mlm_head="mlm" in params)

    def map_params(self, raw_get, cfg):
        get = _prefixed(raw_get, "distilbert.")

        def layer(i):
            p = f"transformer.layer.{i}."
            a = p + "attention."
            return _encoder_layer(get, {
                "q": a + "q_lin", "k": a + "k_lin", "v": a + "v_lin", "o": a + "out_lin",
                "up": p + "ffn.lin1", "down": p + "ffn.lin2",
                "ln_attn": p + "sa_layer_norm", "ln_mlp": p + "output_layer_norm"})

        tokens = get("embeddings.word_embeddings.weight")
        D = cfg.d_model
        out = {
            "embed": {"tokens": tokens,
                      "positions": get("embeddings.position_embeddings.weight"),
                      # no token types in distilbert: one all-zero row (index 0)
                      "token_type": _zeros(tokens, 1, D),
                      "ln": _norm(get, "embeddings.LayerNorm")},
            "layers": _layers(cfg, layer),
            # no pooler either: zero weights make pooled = tanh(0)
            "pooler": {"w": _zeros(tokens, D, D), "b": _zeros(tokens, D)},
        }
        if _has(raw_get, "vocab_transform.weight"):     # DistilBertForMaskedLM
            w, b = _linear(raw_get, "vocab_transform")
            out["mlm"] = {"w": w, "b": b, "ln": _norm(raw_get, "vocab_layer_norm"),
                          "decoder_bias": raw_get("vocab_projector.bias")}
        return out


class BertPolicy(HFPolicy):
    """HF ``bert``: the post-LN encoder with token-type embeddings, an
    optional pooler and an optional MLM head (``cls.predictions.*``, the
    decoder tied to the word embeddings). Serves through ``BertModel``'s
    fill-mask / feature surface."""

    model_type = "bert"

    _ACTS = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_pytorch_tanh": "gelu",
             "relu": "relu"}

    def zoo_config(self, hf):
        pet = hf.get("position_embedding_type", "absolute")
        if pet != "absolute":
            raise ValueError(f"unsupported BERT position_embedding_type {pet!r}")
        act = self._ACTS.get(hf.get("hidden_act", "gelu"))
        if act is None:
            raise ValueError(f"unsupported BERT hidden_act {hf.get('hidden_act')!r}")
        return TransformerConfig(
            vocab_size=hf["vocab_size"], n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"], d_model=hf["hidden_size"],
            d_ff=hf["intermediate_size"], max_seq=hf.get("max_position_embeddings", 512),
            pos_embedding="learned", norm="layernorm", norm_position="post",
            activation=act, causal=False, attn_bias=True, tie_embeddings=True,
            norm_eps=hf.get("layer_norm_eps", 1e-12))

    def build_model(self, cfg, hf, params):
        from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
        bc = BertConfig(vocab_size=cfg.vocab_size, max_seq=cfg.max_seq, n_layer=cfg.n_layer,
                        n_head=cfg.n_head, d_model=cfg.d_model, d_ff=cfg.d_ff,
                        type_vocab_size=hf.get("type_vocab_size", 2), norm_eps=cfg.norm_eps,
                        activation=cfg.activation)
        return BertModel(bc, with_mlm_head="mlm" in params)

    def map_params(self, raw_get, cfg):
        def get(name):   # task-head checkpoints carry a "bert." prefix
            try:
                return raw_get("bert." + name)
            except KeyError:
                return raw_get(name)

        def layer(i):
            p = f"encoder.layer.{i}."
            a = p + "attention."
            return _encoder_layer(get, {
                "q": a + "self.query", "k": a + "self.key", "v": a + "self.value",
                "o": a + "output.dense", "up": p + "intermediate.dense",
                "down": p + "output.dense", "ln_attn": a + "output.LayerNorm",
                "ln_mlp": p + "output.LayerNorm"})

        tokens = get("embeddings.word_embeddings.weight")
        out = {
            "embed": {"tokens": tokens,
                      "positions": get("embeddings.position_embeddings.weight"),
                      "token_type": get("embeddings.token_type_embeddings.weight"),
                      "ln": _norm(get, "embeddings.LayerNorm")},
            "layers": _layers(cfg, layer),
        }
        if _has(get, "pooler.dense.weight"):
            w, b = _linear(get, "pooler.dense")
            out["pooler"] = {"w": w, "b": b}
        else:       # headless / MLM-only checkpoints ship no pooler
            from deepspeed_tpu_torch.utils.logging import warn_once
            warn_once("BERT checkpoint has no pooler (add_pooling_layer="
                      "False / MLM-only); pooled output will be tanh(0) "
                      "zeros — use the hidden states or the MLM head")
            D = cfg.d_model
            out["pooler"] = {"w": _zeros(tokens, D, D), "b": _zeros(tokens, D)}
        if _has(raw_get, "cls.predictions.transform.dense.weight"):     # BertForMaskedLM
            w, b = _linear(raw_get, "cls.predictions.transform.dense")
            out["mlm"] = {"w": w, "b": b, "ln": _norm(raw_get, "cls.predictions.transform.LayerNorm"),
                          "decoder_bias": raw_get("cls.predictions.bias")}
        return out


class CLIPPolicy(HFPolicy):
    """HF ``clip`` / ``clip_text_model`` / ``clip_vision_model``. Which towers
    exist is probed from the checkpoint: a full ``CLIPModel`` maps to
    ``DSClipEncoder`` with params ``{"text", "vision", ["logit_scale"]}``; a
    standalone ``CLIPTextModel(WithProjection)`` or
    ``CLIPVisionModel(WithProjection)`` maps to the bare encoder and its own
    tree."""

    model_type = "clip"

    _ACTS = {"quick_gelu": "quick_gelu", "gelu": "gelu_exact", "gelu_new": "gelu",
             "gelu_pytorch_tanh": "gelu"}

    @classmethod
    def _act(cls, sub):
        act = cls._ACTS.get(sub.get("hidden_act", "quick_gelu"))
        if act is None:
            raise ValueError(f"unsupported CLIP hidden_act {sub.get('hidden_act')!r}")
        return act

    @classmethod
    def _text_cfg(cls, tc, projection_dim=None):
        from deepspeed_tpu_torch.models.clip import CLIPTextConfig
        return CLIPTextConfig(
            vocab_size=tc["vocab_size"], max_seq=tc.get("max_position_embeddings", 77),
            n_layer=tc["num_hidden_layers"], n_head=tc["num_attention_heads"],
            d_model=tc["hidden_size"], d_ff=tc["intermediate_size"],
            norm_eps=tc.get("layer_norm_eps", 1e-5), activation=cls._act(tc),
            projection_dim=projection_dim, eos_token_id=tc.get("eos_token_id", 2))

    @classmethod
    def _vision_cfg(cls, vc, projection_dim=None):
        from deepspeed_tpu_torch.models.clip import CLIPVisionConfig
        return CLIPVisionConfig(
            image_size=vc.get("image_size", 224), patch_size=vc.get("patch_size", 32),
            n_layer=vc["num_hidden_layers"], n_head=vc["num_attention_heads"],
            d_model=vc["hidden_size"], d_ff=vc["intermediate_size"],
            norm_eps=vc.get("layer_norm_eps", 1e-5), activation=cls._act(vc),
            projection_dim=projection_dim)

    def zoo_config(self, hf):
        # the text tower governs the config handed to config_overrides (the
        # vision dims go to build_model); a standalone tower carries its
        # fields at the top level: text has vocab_size, vision patch_size
        tc, vc = hf.get("text_config"), hf.get("vision_config")
        if tc is None and vc is None:
            tc = hf if "vocab_size" in hf else None
            vc = hf if tc is None else None
        if tc is not None:
            return self._text_cfg(tc).zoo()
        return self._vision_cfg(vc).zoo()

    def build_model(self, cfg, hf, params):
        from deepspeed_tpu_torch.models.clip import (CLIPTextEncoder, CLIPVisionEncoder,
                                                     DSClipEncoder)
        proj = hf.get("projection_dim")
        text = vision = None
        tparams = params.get("text", params if "layers" in params else None)
        if tparams is not None and "embed" in tparams:
            text = CLIPTextEncoder(self._text_cfg(
                hf.get("text_config", hf), proj if "text_projection" in tparams else None))
        vparams = params.get("vision", params if "patch_embed" in params else None)
        if vparams is not None and "patch_embed" in vparams:
            vision = CLIPVisionEncoder(self._vision_cfg(
                hf.get("vision_config", hf), proj if "visual_projection" in vparams else None))
        if text is not None and vision is not None:
            return DSClipEncoder(text, vision)
        return text if text is not None else vision

    @staticmethod
    def _n_layers(get, fmt):
        n = 0
        while _has(get, fmt.format(n)):
            n += 1
        return n

    def _map_tower(self, get, pre):
        """One tower's layers (the text and vision towers share the HF layer
        schema)."""
        lp = pre + "encoder.layers.{}."

        def layer(i):
            p = lp.format(i)
            a = p + "self_attn."
            return _encoder_layer(get, {
                "q": a + "q_proj", "k": a + "k_proj", "v": a + "v_proj", "o": a + "out_proj",
                "up": p + "mlp.fc1", "down": p + "mlp.fc2",
                "ln_attn": p + "layer_norm1", "ln_mlp": p + "layer_norm2"})
        return [layer(i) for i in range(self._n_layers(get, lp + "layer_norm1.weight"))]

    def _map_text(self, get):
        pre = "text_model."
        return {"embed": {"tokens": get(pre + "embeddings.token_embedding.weight"),
                          "positions": get(pre + "embeddings.position_embedding.weight")},
                "layers": self._map_tower(get, pre),
                "ln_f": _norm(get, pre + "final_layer_norm")}

    def _map_vision(self, get):
        pre = "vision_model."
        # HF's conv patch embedding [D, C, ps, ps] -> [ps * ps * C, D], the
        # patchify's (ps_h, ps_w, C) flattening order
        w = get(pre + "embeddings.patch_embedding.weight")
        return {"patch_embed": w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous(),
                "class_token": get(pre + "embeddings.class_embedding"),
                "positions": get(pre + "embeddings.position_embedding.weight"),
                # sic: HF's attribute is spelled "pre_layrnorm"
                "ln_pre": _norm(get, pre + "pre_layrnorm"),
                "layers": self._map_tower(get, pre),
                "ln_f": _norm(get, pre + "post_layernorm")}

    def map_params(self, get, cfg):
        has_text = _has(get, "text_model.embeddings.token_embedding.weight")
        has_vision = _has(get, "vision_model.embeddings.class_embedding")
        if not (has_text or has_vision):
            raise KeyError("neither text_model.* nor vision_model.* weights found")
        text = self._map_text(get) if has_text else None
        vision = self._map_vision(get) if has_vision else None
        if has_text and _has(get, "text_projection.weight"):
            text["text_projection"] = _t(get("text_projection.weight"))
        if has_vision and _has(get, "visual_projection.weight"):
            vision["visual_projection"] = _t(get("visual_projection.weight"))
        if has_text and has_vision:      # a full CLIPModel
            out = {"text": text, "vision": vision}
            if _has(get, "logit_scale"):
                out["logit_scale"] = get("logit_scale")
            return out
        return text if has_text else vision


POLICIES: Dict[str, HFPolicy] = {
    p.model_type: p() for p in (GPT2Policy, LlamaPolicy, BloomPolicy, OPTPolicy,
                                GPTNeoXPolicy, GPTJPolicy, GPTNeoPolicy,
                                DistilBertPolicy, BertPolicy, CLIPPolicy)
}
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
