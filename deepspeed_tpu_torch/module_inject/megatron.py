"""Megatron-GPT ds_inference checkpoint ingestion (the port's copy of
``deepspeed_tpu/module_inject/megatron.py``).

Flow: the meta json lists per-TP-rank files -> :class:`MegatronSDLoader`
merges them (qkv-aware, ``checkpoint/state_dict_factory.py``) -> this module
maps Megatron tensor names to the port's tree for the model's
``TransformerConfig``. The fused qkv layout depends on the checkpoint
version:

- v0:   ``[3·np·hn, h]``: after the loader's qkv-aware merge the full
  tensor is ``[q | k | v]`` block-concat;
- v1.0: ``[np·hn·3, h]``: per head, per head-dim, (q,k,v) interleaved;
- v2.0: ``[np·3·hn, h]``: per head ``[q_h | k_h | v_h]`` (NeoX-style).

Megatron-DeepSpeed MoE layers (the reference policy
``module_inject/containers/megatron_gpt_moe.py``) map to the zoo
``MoECausalLM``'s layer trees: standard MoE under ``mlp.deepspeed_moe``,
residual (PR-)MoE under ``mlp.moe.deepspeed_moe`` with its dense branch
``mlp.mlp`` and ``mlp.coefficient``; every layer must be MoE."""

from __future__ import annotations

from typing import Any, Dict

import torch


def megatron_merge_strategies(version=0) -> Dict[str, Any]:
    """Per-tensor TP merge strategy (Megatron column-parallel weights shard
    dim 0 in the torch [out, in] layout, row-parallel dim 1, vocab-parallel
    embedding dim 0; row-parallel biases and layernorms replicate).

    Fused qkv: version 0 ranks hold contiguous ``[q_i | k_i | v_i]`` blocks,
    so the merge must be q/k/v-aware; v1.0 / v2.0 lay q/k/v out per HEAD, so
    rank shards concatenate plainly."""
    qkv = (0, "qkv") if version == 0 else 0
    return {
        "attention.query_key_value.weight": qkv,
        "attention.query_key_value.bias": qkv,
        "attention.dense.weight": 1,
        # no "mlp." prefix: the same column/row-parallel split applies to the
        # dense mlp AND the MoE expert FFNs
        "dense_h_to_4h.weight": 0,
        "dense_h_to_4h.bias": 0,
        "dense_4h_to_h.weight": 1,
        "word_embeddings.weight": 0,
    }


def _split_fused_qkv(w3: torch.Tensor, H: int, Hd: int, version) -> tuple:
    """Version-aware de-fuse of a MERGED qkv tensor (weight [3D, D] or bias
    [3D]) into (q, k, v), each transposed to the port's [in, out] layout."""
    D = w3.shape[0] // 3
    rest = tuple(w3.shape[1:])
    if version == 0:
        q, k, v = torch.tensor_split(w3, 3, dim=0)          # [q | k | v]
    elif float(version) == 1.0:
        r = w3.reshape((H, Hd, 3) + rest)                   # per-dim triples
        q, k, v = (r[:, :, i].reshape((D,) + rest) for i in range(3))
    elif float(version) == 2.0:
        r = w3.reshape((H, 3, Hd) + rest)                   # per-head blocks
        q, k, v = (r[:, i].reshape((D,) + rest) for i in range(3))
    else:
        raise ValueError(f"unsupported Megatron checkpoint version {version!r}")
    if w3.ndim == 2:  # torch [out, in] -> port [in, out]
        q, k, v = q.t(), k.t(), v.t()
    return q.contiguous(), k.contiguous(), v.contiguous()


def map_megatron_params(sd: Dict[str, torch.Tensor], cfg, version=0, dtype=None,
                        device=None) -> Dict[str, Any]:
    """Merged Megatron-GPT state dict -> the port's tree for ``cfg``, each
    tensor cast to ``dtype`` and moved to ``device`` (the file's dtype and
    the CPU when None) before it is transposed or split."""
    def g(name):
        for pre in ("", "module.", "model.", "language_model.",
                    # embedding / transformer scoping variants
                    "language_model.embedding.", "embedding."):
            t = sd.get(pre + name)
            if t is not None:
                t = torch.as_tensor(t)
                return t.to(device=device or t.device,
                            dtype=dtype if dtype is not None and t.is_floating_point()
                            else t.dtype, copy=True)
        raise KeyError(name)

    H, Hd = cfg.n_head, cfg.head_dim
    lp = None
    for cand in ("transformer.layers", "language_model.transformer.layers",
                 "encoder.layers", "language_model.encoder.layers"):
        if any(k.startswith(cand) or k.startswith("module." + cand) for k in sd):
            lp = cand
            break
    if lp is None:
        raise KeyError("no Megatron transformer layers found in state dict")
    L = cfg.n_layer
    # standard MoE nests under mlp.deepspeed_moe; residual (PR-)MoE under
    # mlp.moe.deepspeed_moe with a dense mlp.mlp branch and mlp.coefficient
    is_residual = any(".mlp.moe.deepspeed_moe." in k for k in sd)
    is_moe = is_residual or any(".mlp.deepspeed_moe." in k for k in sd)
    if is_moe:
        moe_root = "mlp.moe.deepspeed_moe" if is_residual else "mlp.deepspeed_moe"
        ex = f"{lp}.{{}}.{moe_root}.experts.deepspeed_experts.{{}}"

        def has(name):
            try:
                g(name)
                return True
            except KeyError:
                return False

        dense_layers = [i for i in range(L) if not has(ex.format(i, 0) + ".dense_h_to_4h.weight")]
        if dense_layers:
            # e.g. Megatron-DeepSpeed --moe-layer-freq 2 alternating stacking
            raise NotImplementedError(
                f"mixed dense/MoE layer stacking is not supported (layers {dense_layers} of {L} "
                "have no deepspeed_moe experts, e.g. a --moe-layer-freq > 1 checkpoint); the "
                "zoo MoECausalLM stacks an MoE MLP in every layer")
        E = 0
        while has(ex.format(0, E) + ".dense_h_to_4h.weight"):
            E += 1

    fl = "final_layernorm"
    cand = f"{lp.rsplit('.layers', 1)[0]}.final_layernorm"
    try:
        g(cand + ".weight")
        fl = cand
    except KeyError:
        pass

    def t(a):
        return a.t().contiguous()

    def layer(i):
        p = f"{lp}.{i}."
        q, k, v = _split_fused_qkv(g(p + "attention.query_key_value.weight"), H, Hd, version)
        bq, bk, bv = _split_fused_qkv(g(p + "attention.query_key_value.bias"), H, Hd, version)
        return {
            "ln_attn": {"scale": g(p + "input_layernorm.weight"),
                        "bias": g(p + "input_layernorm.bias")},
            "attn": {"wq": q, "wk": k, "wv": v, "bq": bq, "bk": bk, "bv": bv,
                     "wo": t(g(p + "attention.dense.weight")),
                     "bo": g(p + "attention.dense.bias")},
            "ln_mlp": {"scale": g(p + "post_attention_layernorm.weight"),
                       "bias": g(p + "post_attention_layernorm.bias")},
            "mlp": moe_mlp(i) if is_moe else {
                "w_up": t(g(p + "mlp.dense_h_to_4h.weight")),
                "b_up": g(p + "mlp.dense_h_to_4h.bias"),
                "w_down": t(g(p + "mlp.dense_4h_to_h.weight")),
                "b_down": g(p + "mlp.dense_4h_to_h.bias")},
        }

    def moe_mlp(i):
        """Layer i's gate (torch ``wg [E, D]`` -> ``gate_w [D, E]``) and its
        experts stacked ``[E, ...]`` (a missing expert key raises)."""
        def experts(suffix, tr=False):
            return torch.stack([t(g(ex.format(i, e) + suffix)) if tr
                                else g(ex.format(i, e) + suffix) for e in range(E)])

        p = f"{lp}.{i}.mlp."
        out = {"gate_w": t(g(f"{lp}.{i}.{moe_root}.gate.wg.weight")),
               "w_up": experts(".dense_h_to_4h.weight", tr=True),
               "b_up": experts(".dense_h_to_4h.bias"),
               "w_down": experts(".dense_4h_to_h.weight", tr=True),
               "b_down": experts(".dense_4h_to_h.bias")}
        if is_residual:
            out.update(res_w_up=t(g(p + "mlp.dense_h_to_4h.weight")),
                       res_b_up=g(p + "mlp.dense_h_to_4h.bias"),
                       res_w_down=t(g(p + "mlp.dense_4h_to_h.weight")),
                       res_b_down=g(p + "mlp.dense_4h_to_h.bias"),
                       coef_w=t(g(p + "coefficient.weight")),
                       coef_b=g(p + "coefficient.bias"))
        return out

    return {
        "embed": {"tokens": g("word_embeddings.weight"),
                  "positions": g("position_embeddings.weight")},
        "layers": [layer(i) for i in range(L)],
        "ln_f": {"scale": g(fl + ".weight"), "bias": g(fl + ".bias")},
    }


def load_megatron_checkpoint(ckpt_json, cfg, quantize: bool = False,
                             quantize_bits: int = 8, quantize_groups: int = 64,
                             mlp_extra_grouping: bool = True, dtype=torch.float32,
                             device="cpu"):
    """ds_inference meta json (``{"type": "Megatron", "checkpoints": [...],
    "version": V}``, a path or a dict) -> the port's ParamTree for the model
    config ``cfg``, floating-point tensors in ``dtype`` on ``device``.

    ``quantize`` flags mirror the reference SD loader's quantize-on-load
    surface; quantization runs AFTER name-mapping, so the per-group scales
    fall on the last axis of the port's ``[in, out]`` layout, as the JAX
    package's do (``runtime/weight_quantizer.py``)."""
    from deepspeed_tpu_torch.checkpoint.state_dict_factory import SDLoaderFactory
    from deepspeed_tpu_torch.models import ParamTree

    sd_type, paths, version = SDLoaderFactory.get_sd_loader_json(ckpt_json)
    if str(sd_type).lower() not in ("megatron", "ds_model"):
        raise ValueError(f"unsupported ds_inference checkpoint type {sd_type!r}")
    loader = SDLoaderFactory.get_sd_loader(paths, sd_type, version)
    merged = loader.load(mp_world_size=1, merge_strategies=megatron_merge_strategies(version))
    params = ParamTree(map_megatron_params(merged, cfg, version=version, dtype=dtype,
                                           device=torch.device(device)))
    if quantize:
        from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization
        wq = WeightQuantization(mlp_extra_grouping=mlp_extra_grouping)
        params = wq.quantize_params(params, quantize_bits, quantize_groups,
                                    include_head=not cfg.tie_embeddings)
    return params
