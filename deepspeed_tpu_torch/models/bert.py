"""BERT family: a post-LN bidirectional encoder and its MLM head (the port's
copy of ``deepspeed_tpu/models/bert.py``).

The encoder is the shared backbone's post-LN block (``models/transformer.py``
:func:`~deepspeed_tpu_torch.models.transformer.block`) with ``causal=False``
and a key-padding ``mask_bias``: on the card its attention runs kernels A, C
and D, and the MLM loss runs the fused CE kernels through
:func:`~deepspeed_tpu_torch.models.transformer.vocab_head_ce` with the
decoder bias and the tied word embedding as W. Like the port's ``CausalLM``,
:class:`BertModel` holds the config, not the weights: the parameter tree is
made by :meth:`BertModel.init_params` or loaded, and passed to every call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.utils.init_on_device import honors_on_device


def _check_gather_budget(n_masked: int, k: int, budget: float) -> None:
    """Masked positions beyond the MLM gather budget are dropped from the
    loss, which biases training: warn once with the sizing fix. The message
    holds the config values only (``warn_once`` dedupes by string)."""
    if int(n_masked) > int(k):
        from deepspeed_tpu_torch.utils.logging import warn_once
        warn_once(
            f"mlm_gather_budget={float(budget):g} gathers {int(k)} positions "
            "but batches are realising MORE masked labels than that; the "
            "overflow is DROPPED from the MLM loss (biased gradient). Raise "
            "the budget — recommended headroom is >= 1.5x the masking rate "
            "(e.g. 0.25 for 15% masking).")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX package's ``BertConfig``, field for field: ``activation``
    "gelu_exact" is HF's ``gelu`` (erf); ``loss_chunk`` and
    ``fused_cross_entropy`` route the MLM head as in ``TransformerConfig``;
    ``dropout`` applies only when the loss is given a generator;
    ``mlm_gather_budget`` > 0 runs only the masked positions, a static
    ``budget x B x S`` of them, through the head (positions past the budget
    are dropped from the loss, with a warning)."""
    vocab_size: int = 30522
    max_seq: int = 512
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    activation: str = "gelu_exact"
    remat: Any = True
    attention_backend: str = "auto"
    loss_chunk: int = 0
    fused_cross_entropy: str = "auto"
    dropout: float = 0.0
    scan_layers: bool = True
    mlm_gather_budget: float = 0.0

    def zoo(self) -> T.TransformerConfig:
        return T.TransformerConfig(
            vocab_size=self.vocab_size, max_seq=self.max_seq,
            n_layer=self.n_layer, n_head=self.n_head, d_model=self.d_model,
            d_ff=self.d_ff, pos_embedding="learned", norm="layernorm",
            norm_position="post", activation=self.activation, causal=False,
            attn_bias=True, norm_eps=self.norm_eps, tie_embeddings=True,
            remat=self.remat, attention_backend=self.attention_backend,
            scan_layers=self.scan_layers, dropout=self.dropout,
            loss_chunk=self.loss_chunk,
            fused_cross_entropy=self.fused_cross_entropy)


_MLM_ACT = {"gelu_exact": F.gelu, "gelu": lambda h: F.gelu(h, approximate="tanh"),
            "relu": F.relu}


class BertModel(nn.Module):
    """HF ``BertModel`` semantics: word, position and token-type embeddings
    with LN, the post-LN encoder stack, a tanh pooler on [CLS]; with
    ``with_mlm_head`` the MLM head (dense, the config's activation, LN, and
    the tied decoder with its bias). ``zoo_cfg`` is the backbone's config,
    derived from ``config`` at each read; what is set on it beyond that
    (``replace_self_attention``'s sparsity) is kept as an override."""

    def __init__(self, config: BertConfig, with_mlm_head: bool = False,
                 param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self._zoo_over = {}
        self.with_mlm_head = with_mlm_head
        self.param_dtype = param_dtype

    @property
    def zoo_cfg(self) -> T.TransformerConfig:
        return dataclasses.replace(self.config.zoo(), **self._zoo_over)

    @zoo_cfg.setter
    def zoo_cfg(self, cfg: T.TransformerConfig) -> None:
        base = self.config.zoo()
        self._zoo_over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                          if getattr(cfg, f.name) != getattr(base, f.name)}

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=None) -> T.ParamTree:
        """Random parameters in the JAX package's layout, drawn from
        ``generator`` on ``device`` (values differ from ``jax.random``'s)."""
        c = self.config
        dtype = self.param_dtype if dtype is None else dtype
        p = T.init_params(self.zoo_cfg, generator, device, dtype).to_dict()

        def normal(shape):
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            return (w * 0.02).to(dtype)

        def ln():
            return {"scale": torch.ones(c.d_model, device=device, dtype=dtype),
                    "bias": torch.zeros(c.d_model, device=device, dtype=dtype)}

        zeros = lambda n: torch.zeros(n, device=device, dtype=dtype)
        out = {"embed": {"tokens": p["embed"]["tokens"], "positions": p["embed"]["positions"],
                         "token_type": normal((c.type_vocab_size, c.d_model)), "ln": ln()},
               "layers": p["layers"],
               "pooler": {"w": normal((c.d_model, c.d_model)), "b": zeros(c.d_model)}}
        if self.with_mlm_head:
            out["mlm"] = {"w": normal((c.d_model, c.d_model)), "b": zeros(c.d_model),
                          "ln": ln(), "decoder_bias": zeros(c.vocab_size)}
        return T.ParamTree(out)

    def __call__(self, params, input_ids, token_type_ids=None, attention_mask=None,
                 rng: Optional[torch.Generator] = None):
        """-> ``(last_hidden [B, S, D], pooled [B, D])``. ``rng`` (the
        training loss only) enables ``config.dropout``; without it the call
        is deterministic."""
        cfg = self.zoo_cfg
        emb = params["embed"]
        input_ids = torch.as_tensor(input_ids, device=emb["tokens"].device).long()
        B, S = input_ids.shape
        x = emb["tokens"][input_ids] + emb["positions"][:S][None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + emb["token_type"][torch.as_tensor(token_type_ids, device=x.device).long()]
        x = T._norm(cfg, x, emb["ln"])
        k_embed, k_layers = (T._seeds(rng, 2) if rng is not None and cfg.dropout
                             else (None, None))
        x = T._dropout(cfg, x, T._generator(k_embed, x.device))
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        mask = None if attention_mask is None else torch.as_tensor(attention_mask,
                                                                   device=x.device)
        x = T.run_layers(cfg, x, params["layers"], positions, T.key_mask_bias(mask),
                         rng=T._generator(k_layers, "cpu"))
        # post-LN stacks end inside the last block: no final norm here
        pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
        return x, pooled

    def forward(self, params, tokens, attn_mask=None):
        """The inference engine's surface (``fwd(params, tokens, mask)``):
        MLM logits when the head exists, else the last hidden states."""
        if self.with_mlm_head:
            return self.mlm_logits(params, tokens, attention_mask=attn_mask)
        return self(params, tokens, attention_mask=attn_mask)[0]

    @property
    def num_parameters(self) -> int:
        c = self.config
        # per block: qkv/out + 2 FFN mats; biases bq/bk/bv/bo + b_down + two
        # LNs = 9 d_model, b_up = d_ff
        block = 4 * c.d_model * c.d_model + 2 * c.d_model * c.d_ff + 9 * c.d_model + c.d_ff
        n = (c.vocab_size + c.max_seq + c.type_vocab_size) * c.d_model
        n += 2 * c.d_model                               # embedding LN
        n += c.n_layer * block
        n += c.d_model * c.d_model + c.d_model           # pooler w + b
        if self.with_mlm_head:
            n += c.d_model * c.d_model + 3 * c.d_model + c.vocab_size
        return n

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approximate training FLOPs a token (6 N plus the attention term).
        With an MLM gather budget the head's matmuls (transform and tied
        decoder) run on ``budget x B x S`` tokens only, and that share is
        taken off."""
        c = self.config
        s = seq_len or c.max_seq
        f = 6.0 * self.num_parameters + 12.0 * c.n_layer * c.d_model * s
        if self.with_mlm_head and c.mlm_gather_budget:
            head = c.d_model * c.d_model + c.d_model * c.vocab_size
            f -= 6.0 * head * (1.0 - min(c.mlm_gather_budget, 1.0))
        return f

    def loss(self, params, batch, rng: Optional[torch.Generator] = None):
        """Masked-LM training loss. batch: dict(input_ids ``[B, S]``, labels
        ``[B, S]`` with -100 on unmasked positions, optional token_type_ids
        and attention_mask). NSP is left out (MLM-only pre-training). With a
        gather budget the masked-position count is read on the host once a
        step, for the overflow warning."""
        if not self.with_mlm_head:
            raise ValueError("training needs the MLM head: "
                             "BertModel(cfg, with_mlm_head=True)")
        x, _ = self(params, batch["input_ids"], batch.get("token_type_ids"),
                    batch.get("attention_mask"), rng=rng)
        labels = torch.as_tensor(batch["labels"], device=x.device).long()
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        w = params["embed"]["tokens"].T
        bias = params["mlm"]["decoder_bias"]
        budget = self.config.mlm_gather_budget
        if budget:
            B, S, D = x.shape
            k = max(1, int(round(min(budget, 1.0) * B * S)))
            k = -(-k // 128) * 128 if k >= 128 else k
            flat_v = valid.reshape(-1)
            _check_gather_budget(get_accelerator(x.device.type).to_host(flat_v.sum()), k, budget)
            # a stable sort: within the budget the CE sums exactly the masked set
            idx = torch.argsort((~flat_v).to(torch.int8), stable=True)[:k]
            h = self._mlm_transform(params, x.reshape(B * S, D)[idx][None])
            return T.vocab_head_ce(self.config, h, w, bias, safe.reshape(-1)[idx][None],
                                   flat_v[idx][None])
        h = self._mlm_transform(params, x)
        return T.vocab_head_ce(self.config, h, w, bias, safe, valid)

    def _mlm_transform(self, params, x):
        """HF ``BertPredictionHeadTransform``: dense, the config's
        activation (relu / gelu_new checkpoints differ from a fixed gelu),
        LN."""
        m = params["mlm"]
        return T._norm(self.zoo_cfg, _MLM_ACT[self.config.activation](x @ m["w"] + m["b"]),
                       m["ln"])

    def mlm_logits(self, params, input_ids, token_type_ids=None, attention_mask=None):
        """Masked-LM logits ``[B, S, vocab]`` (HF ``BertForMaskedLM``'s head)."""
        if params.get("mlm") is None:
            raise ValueError("model has no MLM head (with_mlm_head=False)")
        x, _ = self(params, input_ids, token_type_ids, attention_mask)
        h = self._mlm_transform(params, x)
        return h @ params["embed"]["tokens"].T + params["mlm"]["decoder_bias"]

