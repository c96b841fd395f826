"""The MoE causal LM: the transformer backbone with a mixture-of-experts MLP
in every layer (counterpart of ``deepspeed_tpu/models/moe_lm.py``; the
model-zoo analogue of DeepSpeed-MoE's Megatron GPT). The load-balancing
aux loss is averaged over the layers and added to the LM loss.

Parameters: the backbone's tree with each layer's ``mlp`` holding the gate
``gate_w [D, E]`` and the stacked experts ``w_up [E, D, F]``, ``b_up [E,
F]``, ``w_down [E, F, D]``, ``b_down [E, D]`` (plus the PR-MoE dense branch
``res_*`` and ``coef_*`` with ``use_residual``). Where the JAX package
stacks ``[L, E, ...]`` and scans, the port keeps one tree a layer, so
``checkpoint/from_jax.py`` carries the trees across a layer at a time.

Training runs attention through the flash kernels (A forward, C and D
backward on the card) and the gating, dispatch, combine and expert products
in plain torch, as the JAX package leaves them to XLA; the loss runs over
full logits as the JAX ``loss`` does. Random routing (RTS, RSample, Jitter,
top-2's noise) and dropout draw from per-layer generators seeded from the
engine's generator before each layer, so a rematerialised layer draws the
same numbers. Serving (``forward_cached``) routes with eval capacity and no
randomness; its ``valid`` mask keeps bucket padding out of expert capacity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.moe.experts import expert_ffn
from deepspeed_tpu_torch.moe.layer import residual_blend
from deepspeed_tpu_torch.moe.sharded_moe import TopKGate, dispatch_combine
from deepspeed_tpu_torch.utils.init_on_device import honors_on_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The JAX package's ``MoEConfig``, field for field."""
    num_experts: int = 8
    k: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    aux_loss_coef: float = 0.01
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_rts: bool = True
    expert_ff_mult: int = 4
    # residual (PR-)MoE: each MoE MLP blended with a dense MLP through a
    # learned 2-way softmax coefficient (reference moe/layer.py use_residual)
    use_residual: bool = False


class MoECausalLM(nn.Module):
    """A causal LM whose every block's MLP is an MoE layer. Like
    :class:`~deepspeed_tpu_torch.models.CausalLM` it holds the configs, not
    the weights.

    ``exp_counts_sink``: when a list, each routed MLP appends its layer's
    pre-truncation expert counts ``[E]`` (a device tensor, no host sync), the
    port's hook for DeepSpeed's expert-load monitoring."""

    def __init__(self, config: T.TransformerConfig, moe_config: MoEConfig = MoEConfig(),
                 param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.moe = moe_config
        self.param_dtype = param_dtype
        self.num_experts = moe_config.num_experts
        self.exp_counts_sink = None
        m = moe_config
        self.gate = TopKGate(config.d_model, m.num_experts, m.k, m.capacity_factor,
                             m.eval_capacity_factor, m.min_capacity, m.noisy_gate_policy,
                             m.drop_tokens, m.use_rts)

    # -------------------- params -------------------- #

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=None) -> T.ParamTree:
        """Random parameters in the JAX package's layout and scales (gate
        N(0, 1/D), experts N(0, 0.02) up and depth-scaled down, the PR-MoE
        branch likewise), one sub-tree a layer, drawn from ``generator`` on
        ``device``; the values differ from ``jax.random``'s."""
        cfg, moe = self.config, self.moe
        dtype = self.param_dtype if dtype is None else dtype
        # the backbone's tree; its dense MLP (drawn at d_ff 1, so the draw
        # costs nothing) is replaced below
        base = T.init_params(dataclasses.replace(cfg, d_ff=1), generator, device,
                             dtype).to_dict()
        L, D, E = cfg.n_layer, cfg.d_model, moe.num_experts
        Fd = moe.expert_ff_mult * D
        s_in, s_out = 0.02, 0.02 / math.sqrt(2 * L)

        def draw(shape, scale):
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            return (w * scale).to(dtype)

        def zeros(*shape):
            return torch.zeros(shape, device=device, dtype=dtype)

        for lp in base["layers"]:
            mlp = {"gate_w": draw((D, E), 1.0 / math.sqrt(D)),
                   "w_up": draw((E, D, Fd), s_in), "b_up": zeros(E, Fd),
                   "w_down": draw((E, Fd, D), s_out), "b_down": zeros(E, D)}
            if moe.use_residual:
                mlp.update(res_w_up=draw((D, Fd), s_in), res_b_up=zeros(Fd),
                           res_w_down=draw((Fd, D), s_out), res_b_down=zeros(D),
                           coef_w=draw((D, 2), 0.02), coef_b=zeros(2))
            lp["mlp"] = mlp
        return T.ParamTree(base)

    # -------------------- forward -------------------- #

    def _moe_mlp(self, lp, x, generator: Optional[torch.Generator], train: bool,
                 used_token=None):
        """x ``[B, S, D]`` -> (``[B, S, D]``, l_aux) through the layer's
        :class:`TopKGate` (its Jitter scales the router's input only, as the
        reference gate's does), :func:`expert_ffn` and, with
        ``use_residual``, :func:`residual_blend`; int8 expert leaves
        dequantize there. ``used_token`` ``[B*S]`` 1/0 keeps masked tokens
        out of capacity (top-1 only; the reference's top-2 gate has no mask
        either)."""
        B, S, D = x.shape
        tokens = x.reshape(-1, D)
        l_aux, combine, dispatch, counts = self.gate({"wg": lp["gate_w"]}, tokens, used_token,
                                                     generator, train)
        if self.exp_counts_sink is not None:
            self.exp_counts_sink.append(counts)
        eps = {k: lp[k] for k in ("w_up", "b_up", "w_down", "b_down")}
        out = dispatch_combine(tokens, combine, dispatch, expert_ffn, eps)
        if self.moe.use_residual:
            res = {k: lp["res_" + k] for k in ("w_up", "b_up", "w_down", "b_down")}
            out = residual_blend(tokens, out, res, lp["coef_w"], lp["coef_b"])
        return out.reshape(B, S, D), l_aux

    def _block(self, x, lp, positions, mask_bias, seed: Optional[int], train: bool):
        cfg = self.config
        gen = T._generator(seed, x.device)
        drop = gen if (cfg.dropout and train) else None
        a = T.attention(cfg, T._norm(cfg, x, lp["ln_attn"]), lp["attn"], positions, mask_bias)
        x = x + T._dropout(cfg, a, drop)
        m, l_aux = self._moe_mlp(lp["mlp"], T._norm(cfg, x, lp["ln_mlp"]), gen, train)
        return x + T._dropout(cfg, m, drop), l_aux

    def forward(self, params, tokens, attn_mask=None,
                rng: Optional[torch.Generator] = None, train: bool = True):
        """tokens ``[B, S]`` -> (logits ``[B, S, vocab]``, aux loss averaged
        over the layers). ``rng`` seeds each layer's routing draws (and
        dropout); without one routing draws nothing (RTS falls back to
        positional priority), so eval is deterministic."""
        cfg = self.config
        B, S = tokens.shape
        tokens = tokens.long()
        x = params["embed"]["tokens"][tokens]
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        if cfg.pos_embedding == "learned":
            x = x + params["embed"]["positions"][:S][None, :, :]
        mask_bias = T.key_mask_bias(attn_mask)
        layers = list(params["layers"])
        seeds = T._seeds(rng, len(layers))
        aux = torch.zeros((), device=x.device, dtype=torch.float32)
        for lp, seed in zip(layers, seeds):
            # any truthy remat (a policy's name, "none" too) is full remat,
            # as in the JAX model (moe_lm.py:178)
            if cfg.remat:
                x, l_aux = checkpoint(self._block, x, lp, positions, mask_bias, seed, train,
                                      use_reentrant=False)
            else:
                x, l_aux = self._block(x, lp, positions, mask_bias, seed, train)
            aux = aux + l_aux
        x = T._norm(cfg, x, params["ln_f"])
        return x @ T._head_weight(cfg, params), aux / cfg.n_layer

    # -------------------- KV-cache serving -------------------- #

    def init_cache(self, batch_size: int, max_len: Optional[int] = None, dtype=torch.bfloat16,
                   device="cpu") -> Dict[str, torch.Tensor]:
        return T.init_kv_cache(self.config, batch_size, max_len, dtype, device)

    def forward_cached(self, params, tokens, cache, pos: int, pad_bias=None, valid=None):
        """Incremental decode on the shared cached path with the routed MLP
        slotted in (eval capacity, no randomness): a one-token step attends
        through the dense decode kernel (K5), a prompt through the grouped
        einsum. ``valid`` ``[B, T]`` (1 = real token) keeps bucket padding
        out of the capacity competition (top-1's used_token). Capacity is
        per call, so at tight capacity a decoded step can drop differently
        than the same token inside one long forward (the reference's
        per-forward semantics)."""
        used = None if valid is None else valid.reshape(-1)

        def routed(cfg, x_normed, lp):
            return self._moe_mlp(lp["mlp"], x_normed, None, False, used)[0]

        return T.forward_cached(self.config, params, tokens, cache, pos, pad_bias,
                                mlp_fn=routed)

    # -------------------- training -------------------- #

    def loss(self, params, batch, rng: Optional[torch.Generator] = None,
             ignore_index: int = -100):
        """LM cross-entropy over full fp32 logits plus ``aux_loss_coef`` x
        the aux loss (the JAX ``loss``)."""
        tokens = batch["input_ids"]
        logits, aux = self.forward(params, tokens, batch.get("attention_mask"), rng=rng,
                                   train=True)
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], ignore_index)],
                               dim=1)
        labels = labels.long().to(logits.device)
        valid = labels != ignore_index
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
        lm = torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)
        return lm + self.moe.aux_loss_coef * aux

    @property
    def num_parameters(self) -> int:
        """The JAX package's count (its formula, residual branch left out
        as there)."""
        cfg, moe = self.config, self.moe
        D, E = cfg.d_model, moe.num_experts
        Fd = moe.expert_ff_mult * D
        embed = cfg.vocab_size * D + (cfg.max_seq * D if cfg.pos_embedding == "learned" else 0)
        attn = D * cfg.head_dim * (cfg.n_head + 2 * cfg.kv_heads) + cfg.n_head * cfg.head_dim * D
        moe_mlp = D * E + E * (2 * D * Fd + Fd + D)
        norms = (4 if cfg.norm == "layernorm" else 2) * D
        final_norm = (2 if cfg.norm == "layernorm" else 1) * D
        head = 0 if cfg.tie_embeddings else D * cfg.vocab_size
        return embed + cfg.n_layer * (attn + moe_mlp + norms) + final_norm + head

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approximate training FLOPs a token: 6 x the parameters a token
        meets (k of the E experts a layer) plus the attention term, as
        ``CausalLM.flops_per_token`` counts a dense model."""
        cfg, moe = self.config, self.moe
        D, Fd = cfg.d_model, moe.expert_ff_mult * cfg.d_model
        idle = cfg.n_layer * (moe.num_experts - moe.k) * (2 * D * Fd + Fd + D)
        s = seq_len or cfg.max_seq
        return 6.0 * (self.num_parameters - idle) + 12.0 * cfg.n_layer * D * s
