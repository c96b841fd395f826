"""Sparse-attention integration utilities: the counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py`` (reference
``SparseAttentionUtils``): padding inputs to the sparsity block, extending
learned position embeddings, and swapping a model's self-attention for
block-sparse attention.

As in the JAX package the models hold their config, not their weights, so
"module surgery" is a config replacement: :func:`replace_self_attention`
returns a new model whose ``TransformerConfig.sparse_attention`` carries the
sparsity config, and every layer then attends through
``models/transformer.py::_sparse_model_attention``. Position extension is a
transform of the parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F



def pad_to_block_size(block_size: int, input_ids, attention_mask=None, token_type_ids=None,
                      pad_token_id: int = 0) -> Tuple[int, Any, Any, Any]:
    """Pad ``[B, S]`` inputs along the sequence to a multiple of
    ``block_size`` (reference ``SparseAttentionUtils.pad_to_block_size``).
    Padded positions get ``pad_token_id`` and attention_mask 0 (a mask of
    ones is made when the caller had none, so the pad tokens are never
    attended). Returns ``(pad_len, input_ids, attention_mask,
    token_type_ids)``."""
    S = input_ids.shape[1]
    pad_len = (-S) % block_size
    if pad_len == 0:
        return 0, input_ids, attention_mask, token_type_ids
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    input_ids = F.pad(input_ids, (0, pad_len), value=pad_token_id)
    attention_mask = F.pad(attention_mask, (0, pad_len))
    if token_type_ids is not None:
        token_type_ids = F.pad(token_type_ids, (0, pad_len))
    return pad_len, input_ids, attention_mask, token_type_ids


def unpad_sequence_output(pad_len: int, sequence_output):
    """Strip the padding :func:`pad_to_block_size` added from a ``[B, S,
    ...]`` output (reference ``unpad_sequence_output``)."""
    if pad_len == 0:
        return sequence_output
    return sequence_output[:, :-pad_len]


def extend_position_embedding(params, new_max_seq: int,
                              path: Tuple[str, ...] = ("embed", "positions")):
    """Extend learned position embeddings to ``new_max_seq`` rows by
    repeating the trained table (reference ``extend_position_embedding``).
    ``params`` is a ``ParamTree`` or its nested dict; returns a new tree of
    the same kind, this one left as it is. Rebuild the model with
    ``max_seq=new_max_seq`` as well (:func:`replace_self_attention`)."""
    from deepspeed_tpu_torch.models.transformer import ParamTree
    is_tree = isinstance(params, ParamTree)
    tree = params.to_dict() if is_tree else params
    sub = tree
    for key in path[:-1]:
        sub = sub[key]
    old = torch.as_tensor(sub[path[-1]])
    P = old.shape[0]
    if new_max_seq <= P:
        raise ValueError(f"new_max_seq={new_max_seq} does not exceed the current table ({P})")
    new = old.repeat(-(-new_max_seq // P), 1)[:new_max_seq].clone()

    def rebuild(node, keys):
        if not keys:
            return new
        out = dict(node)
        out[keys[0]] = rebuild(node[keys[0]], keys[1:])
        return out

    out = rebuild(tree, list(path))
    return ParamTree(out, requires_grad=any(p.requires_grad for p in params.parameters())) \
        if is_tree else out


def replace_self_attention(model, sparsity_config, max_seq: Optional[int] = None):
    """A new model whose every layer runs block-sparse attention over
    ``sparsity_config``'s layout (reference
    ``replace_model_self_attention_with_sparse_self_attention``). Takes the
    port's ``CausalLM`` and ``BertModel``; ``max_seq`` raises its sequence
    limit at the same time (pair it with :func:`extend_position_embedding`)."""
    from deepspeed_tpu_torch.models.bert import BertModel
    from deepspeed_tpu_torch.models.causal_lm import CausalLM
    if isinstance(model, BertModel):
        bc = model.config
        if max_seq is not None:
            bc = dataclasses.replace(bc, max_seq=max_seq)
        out = BertModel(bc, with_mlm_head=model.with_mlm_head, param_dtype=model.param_dtype)
        out.zoo_cfg = dataclasses.replace(out.zoo_cfg, sparse_attention=sparsity_config)
        return out
    if isinstance(model, CausalLM):
        over = {"sparse_attention": sparsity_config}
        if max_seq is not None:
            over["max_seq"] = max_seq
        return type(model)(dataclasses.replace(model.config, **over), model.param_dtype)
    raise TypeError(f"cannot sparsify {type(model).__name__}; expected a zoo "
                    "CausalLM or BertModel")
