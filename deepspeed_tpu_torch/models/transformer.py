"""Decoder transformer: the serving and training subsets of
``deepspeed_tpu/models/transformer.py`` in PyTorch.

Same ``TransformerConfig`` fields, same parameter-tree keys and ``[in, out]``
matmul layout (so weights made by the JAX package load unchanged, see
``checkpoint/from_jax.py``), same paged-KV serving entry points. Where the
JAX package runs one ``lax.scan`` over stacked layer weights, the port keeps
one parameter sub-tree per layer and loops over them in Python.

KV pools are ``[n_layer, num_blocks, block_size, KV, Hd]`` tensors updated
IN PLACE: JAX donated the pool buffers through every fused step and returned
new ones; the port writes the new k/v into the same tensors with
``index_copy_`` and returns the pools dict unchanged, so callers written for
either convention work.

Attention dispatch (``attention_backend``): ``"auto"`` and ``"flash"`` call
the kernel wrappers in ``ops/kernels`` (the hand-written CUDA kernel for
CUDA tensors, its plain version for CPU tensors); ``"xla"`` keeps the plain
einsum paths of the JAX package's non-kernel branch.

The dense KV workspace of static generation (:func:`init_kv_cache`,
:func:`forward_cached`) is ``[n_layer, B, Smax, KV, Hd]``, also updated in
place: the new k/v land at ``pos`` (JAX's ``dynamic_update_slice``), and a
one-token step attends through the dense decode kernel (K5).

Training (:func:`lm_loss`) runs the same blocks under autograd: flash
attention is differentiable through the backward kernels, ``remat`` True /
"full" recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), and the vocab head runs the
fused logits-free CE kernels (K3) where ``fused_cross_entropy`` selects
them, else the plain ``chunked_vocab_ce``.
Dropout draws from an explicit ``torch.Generator`` through per-layer integer
seeds taken before each checkpointed block, so a recomputed block draws the
same mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.attention import mha_attention
from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.fused_cross_entropy import fused_cross_entropy
from deepspeed_tpu_torch.ops.kernels.paged_decode_attention import paged_decode_attention
from deepspeed_tpu_torch.sequence._streaming import chunked_attention
from deepspeed_tpu_torch.utils.not_ported import not_ported


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's ``TransformerConfig``, field for field. Training
    and sharding knobs (remat, scan_layers, sequence_parallel, manual_tp,
    loss_chunk, fused_cross_entropy, dropout) are carried for config parity;
    the serving slice does not read them."""
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None           # default 4*d_model (or 8/3 for swiglu)
    max_seq: int = 1024
    n_kv_head: Optional[int] = None      # GQA; default n_head
    pos_embedding: str = "learned"       # learned | rope | alibi | none
    norm: str = "layernorm"              # layernorm | rmsnorm
    activation: str = "gelu"             # gelu (tanh) | gelu_exact | quick_gelu | swiglu | relu
    parallel_residual: bool = False      # gpt-neox style
    norm_position: str = "pre"           # pre (GPT) | post (BERT add&norm)
    causal: bool = True
    tie_embeddings: bool = True
    embed_layernorm: bool = False        # BLOOM word_embeddings_layernorm
    attn_bias: bool = False              # qkv/out biases (gpt2/opt/bloom/neox)
    rope_theta: float = 10000.0
    rope_dim: int = 0                    # 0 = full head dim; else partial
    rope_interleaved: bool = False       # GPT-J pairing vs NeoX half-split
    lm_head_bias: bool = False
    norm_eps: float = 1e-5
    dropout: float = 0.0
    remat: Any = True
    scan_layers: bool = True
    sequence_parallel: str = "none"
    attention_backend: str = "auto"      # auto | flash = kernels; xla = plain einsum
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None
    sparse_attention: Optional[Any] = None
    loss_chunk: int = 0
    fused_cross_entropy: str = "auto"
    attn_scale: Optional[float] = None   # None = head_dim**-0.5
    act_quant_bits: int = 0
    act_quant_sym: bool = True
    manual_tp: Optional[str] = None
    init_std: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.activation == "swiglu":
            d = int(8 * self.d_model / 3)
            return (d + 127) // 128 * 128
        return 4 * self.d_model


# --------------------------------------------------------------------- #
# parameters


class ParamTree(nn.Module):
    """A nested dict of tensors held as a module: ``tree["attn"]["wq"]``
    reads like the JAX pytree, lists (the per-layer trees) become
    ``nn.ModuleList``, and ``.parameters()`` / ``named_parameters()`` /
    ``state_dict()`` work as usual (names like ``layers.0.attn.wq``).
    Tensors are frozen parameters (serving) unless ``requires_grad`` is set
    (the training engine's trees)."""

    def __init__(self, tree: Dict[str, Any], requires_grad: bool = False):
        super().__init__()
        self._keys = tuple(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value, requires_grad))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v, requires_grad) for v in value))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(value), requires_grad=requires_grad))

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def get(self, key, default=None):
        return self[key] if key in self._keys else default

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for key in self._keys:
            v = getattr(self, key)
            if isinstance(v, ParamTree):
                out[key] = v.to_dict()
            elif isinstance(v, nn.ModuleList):
                out[key] = [t.to_dict() for t in v]
            else:
                out[key] = v.data
        return out

    def map(self, fn, requires_grad: bool = False) -> "ParamTree":
        """A new tree with ``fn`` applied to every tensor (this one is left
        as it is, unlike ``nn.Module.to``)."""
        return ParamTree(map_tree(fn, self.to_dict()), requires_grad)


def map_tree(fn, tree):
    """``fn`` over every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device="cpu", dtype=torch.float32) -> ParamTree:
    """Random parameters in the JAX package's tree layout (keys, shapes,
    std, depth-scaled out/down projections), one sub-tree per layer, drawn
    from ``generator`` on ``device``. The values differ from ``jax.random``'s;
    to hold the two packages to each other, convert one tree with
    ``checkpoint.from_jax.params_from_jax``."""
    std = cfg.init_std
    L, D, Fd = cfg.n_layer, cfg.d_model, cfg.ff_dim
    H, KV, Hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    out_std = std / math.sqrt(2 * L)

    def dense(shape, scale=std):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def norm_params():
        p = {"scale": torch.ones((D,), device=device, dtype=dtype)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(D)
        return p

    params: Dict[str, Any] = {"embed": {"tokens": dense((cfg.vocab_size, D))}}
    layers = []
    for _ in range(L):
        attn = {"wq": dense((D, H * Hd)), "wk": dense((D, KV * Hd)),
                "wv": dense((D, KV * Hd)), "wo": dense((H * Hd, D), out_std)}
        if cfg.attn_bias:
            attn.update(bq=zeros(H * Hd), bk=zeros(KV * Hd), bv=zeros(KV * Hd), bo=zeros(D))
        if cfg.activation == "swiglu":
            mlp_p = {"w_gate": dense((D, Fd)), "w_up": dense((D, Fd)),
                     "w_down": dense((Fd, D), out_std)}
        else:
            mlp_p = {"w_up": dense((D, Fd)), "b_up": zeros(Fd),
                     "w_down": dense((Fd, D), out_std), "b_down": zeros(D)}
        layers.append({"ln_attn": norm_params(), "attn": attn,
                       "ln_mlp": norm_params(), "mlp": mlp_p})
    params["layers"] = layers
    params["ln_f"] = norm_params()
    if cfg.pos_embedding == "learned":
        params["embed"]["positions"] = dense((cfg.max_seq, D))
    if cfg.embed_layernorm:
        params["embed"]["ln"] = norm_params()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size))
        if cfg.lm_head_bias:
            params["lm_head_bias"] = zeros(cfg.vocab_size)
    return ParamTree(params)


# --------------------------------------------------------------------- #
# blocks


def _norm(cfg: TransformerConfig, x, p):
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def _rope(x, positions, theta: float, rope_dim: int = 0, interleaved: bool = False):
    """Rotary position embedding on ``x [B, S, H, Hd]`` at ``positions
    [B, S]``: NeoX/Llama half-split pairs, or GPT-J interleaved pairs;
    ``rope_dim`` > 0 rotates only the first ``rope_dim`` dims."""
    Hd = x.shape[-1]
    rd = rope_dim or Hd
    half = rd // 2
    xr = x[..., :rd]
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr[..., :half], xr[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd != Hd:
        rotated = torch.cat([rotated, x[..., rd:].to(rotated.dtype)], dim=-1)
    return rotated.to(x.dtype)


# cache length beyond which the kernel-less cached attention streams its
# softmax over key chunks (sequence/_streaming.py) instead of materialising
# T x Smax logits; the JAX package's constants
DENSE_STREAM_THRESHOLD = 4096
DENSE_STREAM_CHUNK = 1024


def _alibi_slopes(n_head: int, device="cpu"):
    start = 2.0**(-8.0 / n_head)
    return torch.tensor([start**(i + 1) for i in range(n_head)], dtype=torch.float32,
                        device=device)


def _qkv_project(cfg: TransformerConfig, x, lp, positions):
    """q ``[B,T,H,Hd]``, k/v ``[B,T,KV,Hd]`` from ``x [B,T,D]``: projections,
    optional biases, head reshape, rope."""
    B, T, _ = x.shape
    H, KV, Hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q, k, v = q.reshape(B, T, H, Hd), k.reshape(B, T, KV, Hd), v.reshape(B, T, KV, Hd)
    if cfg.pos_embedding == "rope":
        q = _rope(q, positions, cfg.rope_theta, cfg.rope_dim, cfg.rope_interleaved)
        k = _rope(k, positions, cfg.rope_theta, cfg.rope_dim, cfg.rope_interleaved)
    return q, k, v


def _out_project(cfg: TransformerConfig, out, lp):
    out = out @ lp["wo"]
    return out + lp["bo"] if cfg.attn_bias else out


def mlp(cfg: TransformerConfig, x, lp):
    if cfg.activation == "swiglu":
        return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    h = x @ lp["w_up"] + lp["b_up"]
    if cfg.activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.activation == "gelu_exact":
        h = F.gelu(h)
    elif cfg.activation == "quick_gelu":
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = F.relu(h)
    return h @ lp["w_down"] + lp["b_down"]


def cached_embed(cfg: TransformerConfig, params, tokens, pos, dtype):
    """Embedding of ``tokens [B, T]`` at cache offset ``pos`` (an int, or a
    ``[B]`` tensor of per-request offsets). Returns (x, positions [B, T])."""
    B, T = tokens.shape
    x = params["embed"]["tokens"][tokens].to(dtype)
    pos = torch.as_tensor(pos, dtype=torch.long, device=tokens.device).reshape(-1, 1)
    positions = (pos + torch.arange(T, device=tokens.device)[None, :]).expand(B, T)
    if cfg.pos_embedding == "learned":
        # junk pad positions of a bucket may run past the table: clamp the
        # lookup (JAX's gather clamps the same way); rope reads positions as is
        table = params["embed"]["positions"]
        x = x + table[positions.clamp(max=table.shape[0] - 1)].to(x.dtype)
    if cfg.embed_layernorm:
        x = _norm(cfg, x, params["embed"]["ln"])
    return x, positions


def _decode_block(cfg: TransformerConfig, h, lp, attn_fn):
    """The pre-LN residual wiring of every cache-decode block:
    ``attn_fn(x_normed)`` returns the attention output (and updates the
    layer's pools in place)."""
    a = attn_fn(_norm(cfg, h, lp["ln_attn"]))
    if cfg.parallel_residual:
        return h + a + mlp(cfg, _norm(cfg, h, lp["ln_mlp"]), lp["mlp"])
    h = h + a
    return h + mlp(cfg, _norm(cfg, h, lp["ln_mlp"]), lp["mlp"])


def _head_weight(cfg: TransformerConfig, params):
    """``[D, vocab]`` projection (tied embedding transpose or lm_head)."""
    return params["embed"]["tokens"].T if cfg.tie_embeddings else params["lm_head"]


def cached_head(cfg: TransformerConfig, params, x):
    """Final norm + logits projection of the cached path."""
    logits = _norm(cfg, x, params["ln_f"]) @ _head_weight(cfg, params)
    bias = params.get("lm_head_bias")
    return logits if bias is None else logits + bias


# --------------------------------------------------------------------- #
# dense KV workspace (static generate)


def init_kv_cache(cfg: TransformerConfig, batch_size: int, max_len: Optional[int] = None,
                  dtype=torch.bfloat16, device="cpu") -> Dict[str, torch.Tensor]:
    """Preallocated KV cache: k/v ``[n_layer, B, max_len, kv_heads, Hd]``."""
    Smax = max_len or cfg.max_seq
    shape = (cfg.n_layer, batch_size, Smax, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cached_attention(cfg: TransformerConfig, x, lp, positions, pos: int, ck, cv, pad_bias):
    """Attention of T new tokens against one layer's cache ck/cv ``[B, Smax,
    KV, Hd]``, their k/v written at ``pos`` in place first (JAX's
    ``dynamic_update_slice``, whose start clamps so the update fits).
    positions ``[B, T]`` = pos + arange(T) per row. T == 1 goes through the
    dense decode kernel; off its envelope, and for T > 1, a cache longer
    than DENSE_STREAM_THRESHOLD streams the softmax, a shorter one takes the
    grouped einsum. Returns ``[B, T, D]``."""
    B, T, _ = x.shape
    H, Hd = cfg.n_head, cfg.head_dim
    Smax = ck.shape[1]
    q, k, v = _qkv_project(cfg, x, lp, positions)
    start = max(0, min(pos, Smax - T))
    ck[:, start:start + T] = k.to(ck.dtype)
    cv[:, start:start + T] = v.to(cv.dtype)
    slopes = _alibi_slopes(H, x.device) if cfg.pos_embedding == "alibi" else None
    if T == 1 and _use_kernels(cfg):
        o = decode_attention(q[:, 0], ck, cv, pos, pad_bias=pad_bias, alibi_slopes=slopes,
                             scale=cfg.attn_scale)
        if o is not None:
            return _out_project(cfg, o.reshape(B, 1, H * Hd), lp)
    if Smax > DENSE_STREAM_THRESHOLD:
        pb = None if pad_bias is None else pad_bias.float()
        o, _ = chunked_attention(q, ck, cv, pb, slopes, pos, 0, True, DENSE_STREAM_CHUNK,
                                 q.dtype, cfg.attn_scale)
        return _out_project(cfg, o.reshape(B, T, H * Hd), lp)
    return _out_project(cfg, _grouped_cache_einsum(cfg, q, ck, cv, positions, pad_bias), lp)


def cached_block(cfg: TransformerConfig, h, lp, ck, cv, positions, pos: int, pad_bias=None):
    """ONE layer of the KV-cache path: pre-LN attention against, and append
    to, the layer's cache ck/cv ``[B, Smax, KV, Hd]``."""
    return _decode_block(cfg, h, lp, lambda xn: _cached_attention(
        cfg, xn, lp["attn"], positions, pos, ck, cv, pad_bias))


def forward_cached(cfg: TransformerConfig, params, tokens, cache, pos: int, pad_bias=None):
    """tokens ``[B, T]`` (a prompt bucket or one token) attended against,
    and appended to, ``cache`` at offset ``pos`` (a host int). Returns
    (logits ``[B, T, vocab]``, cache) with the cache updated in place.
    ``pad_bias`` ``[B, Smax]`` additive f32 masks cache slots."""
    if cfg.norm_position == "post":
        raise ValueError("norm_position='post' is not supported by the "
                         "KV-cache decode path (pre-LN only)")
    if cfg.sparse_attention is not None:
        raise NotImplementedError(
            "sparse_attention is not supported by the KV-cache decode path; "
            "serve with the dense forward() or drop the sparsity config")
    if cfg.act_quant_bits:
        not_ported("activation fake-quant (act_quant_bits)", "queue 1: compression")
    pos = int(pos)
    x, positions = cached_embed(cfg, params, tokens, pos, cache["k"].dtype)
    for i, lp in enumerate(params["layers"]):
        x = cached_block(cfg, x, lp, cache["k"][i], cache["v"][i], positions, pos, pad_bias)
    return cached_head(cfg, params, x), cache


# --------------------------------------------------------------------- #
# paged KV cache


def init_paged_kv_cache(cfg: TransformerConfig, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, device="cpu") -> Dict[str, torch.Tensor]:
    """Paged KV pools: k/v ``[n_layer, num_blocks, block_size, kv_heads, Hd]``.
    Block 0 is the allocator's dummy block (padding tokens and inactive
    decode rows write there; nothing reads it)."""
    shape = (cfg.n_layer, num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pool_scatter(pool, kv_new, slots):
    """Write per-token k or v ``[N, KV, Hd]`` into one layer's pool
    ``[num_blocks, bs, KV, Hd]`` at flat slots ``[N]`` (block_id * bs +
    offset), in place. Padding positions all land in the dummy block 0, so
    repeated indices there are harmless."""
    flat = pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])
    flat.index_copy_(0, slots.long(), kv_new.to(pool.dtype))


def _paged_gather(pool, block_tables):
    """Dense ``[B, max_blocks * bs, KV, Hd]`` gather of each request's cache
    through its block table."""
    Nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.view(Nb * bs, *pool.shape[2:])
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=pool.device)[None, None, :])
    return flat[idx.reshape(block_tables.shape[0], -1)]


def _grouped_cache_einsum(cfg: TransformerConfig, q, ck, cv, positions, pad_bias):
    """Grouped-head attention of q ``[B,T,H,Hd]`` against an unrepeated cache
    ck/cv ``[B,S,KV,Hd]`` with per-row causal masking at ``positions``
    (head h reads kv head h // G). Scores and softmax in fp32. Returns
    ``[B, T, H*Hd]``."""
    B, T, H, Hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    scale = Hd**-0.5 if cfg.attn_scale is None else cfg.attn_scale
    q5 = q.reshape(B, T, KV, G, Hd)
    scores = torch.einsum("btcgd,bscd->bcgts", q5.float(), ck.float()) * scale
    kpos = torch.arange(S, device=q.device)[None, None, None, None, :]
    qpos = positions[:, None, None, :, None]
    if cfg.pos_embedding == "alibi":
        slopes5 = _alibi_slopes(H, q.device).reshape(KV, G)
        scores = scores + slopes5[None, :, :, None, None] * (kpos - qpos).float()
    scores = torch.where(kpos <= qpos, scores, torch.full_like(scores, -1e30))
    if pad_bias is not None:
        scores = scores + pad_bias.float()[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    return torch.einsum("bcgts,bscd->btcgd", probs, cv).reshape(B, T, H * Hd)


def _use_kernels(cfg: TransformerConfig) -> bool:
    if cfg.attention_backend not in ("auto", "flash", "xla"):
        raise ValueError(f"attention_backend={cfg.attention_backend!r} "
                         "(expected auto | flash | xla)")
    return cfg.attention_backend != "xla"


def _paged_decode_attention(cfg: TransformerConfig, x, lp, positions, pos, kp, vp,
                            block_tables, pad_bias):
    """One fused decode step over all running requests: x ``[B, 1, D]``, pos
    ``[B]`` int32 cache depths, kp/vp one layer's pools, block_tables
    ``[B, max_blocks]`` int32. Writes each request's new k/v at its slot,
    then attends through the paged kernel (or, off its envelope, the gather
    + grouped einsum). Returns ``[B, 1, D]``."""
    B = x.shape[0]
    H, Hd = cfg.n_head, cfg.head_dim
    bs = kp.shape[1]
    q, k, v = _qkv_project(cfg, x, lp, positions)
    pos_l = pos.long()
    slots = block_tables.long()[torch.arange(B, device=x.device), pos_l // bs] * bs + pos_l % bs
    _pool_scatter(kp, k[:, 0], slots)
    _pool_scatter(vp, v[:, 0], slots)
    slopes = _alibi_slopes(H, x.device) if cfg.pos_embedding == "alibi" else None
    o = None
    if _use_kernels(cfg):
        o = paged_decode_attention(q[:, 0], kp, vp, block_tables, pos, pad_bias=pad_bias,
                                   alibi_slopes=slopes, scale=cfg.attn_scale)
    if o is not None:
        out = o.reshape(B, 1, H * Hd)
    else:
        out = _grouped_cache_einsum(cfg, q, _paged_gather(kp, block_tables),
                                    _paged_gather(vp, block_tables), positions, pad_bias)
    return _out_project(cfg, out, lp)


def _paged_prefill_attention(cfg: TransformerConfig, x, lp, positions, kp, vp, slots):
    """Prefill attention of ONE fresh request: causal self-attention over its
    own prompt, its k/v scattered into the request's pool blocks. x
    ``[1, T, D]``; slots ``[T]`` flat pool slots (pads routed to the dummy
    block)."""
    B, T, _ = x.shape
    H, KV, Hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    q, k, v = _qkv_project(cfg, x, lp, positions)
    _pool_scatter(kp, k.reshape(T, KV, Hd), slots)
    _pool_scatter(vp, v.reshape(T, KV, Hd), slots)
    slopes = _alibi_slopes(H, x.device) if cfg.pos_embedding == "alibi" else None
    if _use_kernels(cfg):
        out = flash_attention(q, k, v, causal=True, alibi_slopes=slopes, scale=cfg.attn_scale)
    else:
        out = mha_attention(q, k, v, causal=True, alibi_slopes=slopes, scale=cfg.attn_scale)
    return _out_project(cfg, out.reshape(B, T, H * Hd), lp)


def _paged_chunk_attention(cfg: TransformerConfig, x, lp, positions, kp, vp,
                           block_tables, slots):
    """Prefill-chunk attention of ONE request with cached context (a prefix
    hit or earlier chunks): the chunk's k/v land at ``slots``, then its
    queries attend causally over everything the request has cached via the
    paged gather and the grouped einsum (no kernel, as in the JAX package)."""
    B, T, _ = x.shape
    KV, Hd = cfg.kv_heads, cfg.head_dim
    q, k, v = _qkv_project(cfg, x, lp, positions)
    _pool_scatter(kp, k.reshape(T, KV, Hd), slots)
    _pool_scatter(vp, v.reshape(T, KV, Hd), slots)
    out = _grouped_cache_einsum(cfg, q, _paged_gather(kp, block_tables),
                                _paged_gather(vp, block_tables), positions, None)
    return _out_project(cfg, out, lp)


def _check_paged_config(cfg: TransformerConfig):
    if cfg.norm_position == "post" or not cfg.causal:
        raise ValueError("the paged KV path serves pre-LN causal LMs only")
    if cfg.sparse_attention is not None:
        raise NotImplementedError(
            "sparse_attention is not supported by the paged KV decode path")
    if cfg.act_quant_bits:
        raise NotImplementedError(
            "activation fake-quant (act_quant_bits) is not ported: ROADMAP.md "
            "queue 1, compression")


def forward_paged_prefill(cfg: TransformerConfig, params, tokens, pools, slots, last_idx):
    """Prefill ONE admitted request into its blocks. tokens ``[1, T]``
    right-padded prompt; slots ``[T]`` flat pool slots; last_idx index of the
    last real token. Returns (logits ``[1, vocab]`` at last_idx, pools)."""
    _check_paged_config(cfg)
    x, positions = cached_embed(cfg, params, tokens, 0, pools["k"].dtype)
    for i, lp in enumerate(params["layers"]):
        kp, vp = pools["k"][i], pools["v"][i]
        x = _decode_block(cfg, x, lp, lambda xn: _paged_prefill_attention(
            cfg, xn, lp["attn"], positions, kp, vp, slots))
    xl = x[:, last_idx:last_idx + 1]
    return cached_head(cfg, params, xl)[:, 0, :], pools


def forward_paged_prefill_chunk(cfg: TransformerConfig, params, tokens, pools,
                                block_tables, slots, start_pos, last_idx):
    """Prefill ONE CHUNK of a request with ``start_pos`` tokens already
    cached. tokens ``[1, T]`` the chunk, right-padded; block_tables
    ``[1, max_blocks]``; slots ``[T]``; last_idx the chunk's last real
    token. Returns (logits ``[1, vocab]`` at last_idx, pools)."""
    _check_paged_config(cfg)
    x, positions = cached_embed(cfg, params, tokens, start_pos, pools["k"].dtype)
    for i, lp in enumerate(params["layers"]):
        kp, vp = pools["k"][i], pools["v"][i]
        x = _decode_block(cfg, x, lp, lambda xn: _paged_chunk_attention(
            cfg, xn, lp["attn"], positions, kp, vp, block_tables, slots))
    xl = x[:, last_idx:last_idx + 1]
    return cached_head(cfg, params, xl)[:, 0, :], pools


def forward_paged_decode(cfg: TransformerConfig, params, tokens, pools, block_tables,
                         pos, pad_bias=None):
    """One fused decode step over ALL running requests: tokens ``[B, 1]``,
    block_tables ``[B, max_blocks]`` int32, pos ``[B]`` int32. Returns
    (logits ``[B, vocab]``, pools)."""
    _check_paged_config(cfg)
    x, positions = cached_embed(cfg, params, tokens, pos, pools["k"].dtype)
    for i, lp in enumerate(params["layers"]):
        kp, vp = pools["k"][i], pools["v"][i]
        x = _decode_block(cfg, x, lp, lambda xn: _paged_decode_attention(
            cfg, xn, lp["attn"], positions, pos, kp, vp, block_tables, pad_bias))
    return cached_head(cfg, params, x)[:, 0, :], pools


def copy_paged_block(pools, src: int, dst: int):
    """Copy one pool block across every layer (the scheduler's copy-on-write
    split), in place."""
    for key in ("k", "v"):
        pools[key][:, dst].copy_(pools[key][:, src])
    return pools


# --------------------------------------------------------------------- #
# training forward (lm_loss and what it runs)


def key_mask_bias(attn_mask):
    """``[B, S]`` 1=keep attention mask -> additive key-side bias ``[B, S]``
    (0 keep / -1e9 drop) in fp32; None passes through."""
    if attn_mask is None:
        return None
    return torch.where(attn_mask > 0, 0.0, -1e9).to(torch.float32)


def _dropout(cfg: TransformerConfig, x, generator: Optional[torch.Generator]):
    """Inverted dropout drawn from ``generator``; identity when the rate is
    0 or no generator is given (eval / inference)."""
    if not cfg.dropout or generator is None:
        return x
    keep = 1.0 - cfg.dropout
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def _seeds(rng: Optional[torch.Generator], n: int):
    """``n`` integer seeds from ``rng`` (None each without one): a dropout
    generator rebuilt from its seed draws the same mask when a checkpointed
    block is recomputed."""
    if rng is None:
        return [None] * n
    return [int(s) for s in torch.randint(0, 2**62, (n,), generator=rng)]


def _generator(seed: Optional[int], device):
    return None if seed is None else torch.Generator(device=device).manual_seed(seed)


def attention(cfg: TransformerConfig, x, lp, positions, mask_bias):
    """Multi-head attention of one training block: projections, rope,
    ALiBi, then flash attention (kernels A, C, D on the card) for
    ``attention_backend`` auto / flash, or the plain ``mha_attention`` for
    xla. GQA kv goes in unrepeated."""
    if cfg.sparse_attention is not None:
        not_ported("sparse attention", "queue 1: sparse attention")
    if cfg.sequence_parallel != "none":
        not_ported(f"sequence parallelism ({cfg.sequence_parallel})", "queue 1: sequence/")
    if cfg.manual_tp:
        not_ported("manual tensor parallelism (manual_tp)", "queue 1: runtime/pipe/")
    if cfg.act_quant_bits:
        not_ported("activation fake-quant (act_quant_bits)", "queue 1: compression")
    B, S, _ = x.shape
    H, Hd = cfg.n_head, cfg.head_dim
    q, k, v = _qkv_project(cfg, x, lp, positions)
    slopes = _alibi_slopes(H, x.device) if cfg.pos_embedding == "alibi" else None
    if _use_kernels(cfg):
        out = flash_attention(q, k, v, mask_bias=mask_bias, causal=cfg.causal,
                              alibi_slopes=slopes, scale=cfg.attn_scale)
    else:
        out = mha_attention(q, k, v, mask_bias=mask_bias, causal=cfg.causal,
                            alibi_slopes=slopes, scale=cfg.attn_scale)
    return _out_project(cfg, out.reshape(B, S, H * Hd), lp)


def block(cfg: TransformerConfig, x, lp, positions, mask_bias, seed: Optional[int] = None):
    """One transformer block (pre-LN, parallel-residual or post-LN wiring).
    ``seed`` (training with dropout only) seeds the block's dropout."""
    gen = _generator(seed, x.device) if cfg.dropout else None
    if cfg.norm_position == "post":
        a = _dropout(cfg, attention(cfg, x, lp["attn"], positions, mask_bias), gen)
        x = _norm(cfg, x + a, lp["ln_attn"])
        return _norm(cfg, x + _dropout(cfg, mlp(cfg, x, lp["mlp"]), gen), lp["ln_mlp"])
    a = _dropout(cfg, attention(cfg, _norm(cfg, x, lp["ln_attn"]), lp["attn"], positions,
                                mask_bias), gen)
    if cfg.parallel_residual:
        return x + a + _dropout(cfg, mlp(cfg, _norm(cfg, x, lp["ln_mlp"]), lp["mlp"]), gen)
    x = x + a
    return x + _dropout(cfg, mlp(cfg, _norm(cfg, x, lp["ln_mlp"]), lp["mlp"]), gen)


def _remat(remat) -> bool:
    """Whether each block is recomputed in the backward pass: True / "full"
    (the JAX package's full remat), or not at all (False / "none")."""
    if remat is True or remat == "full":
        return True
    if not remat or remat == "none":
        return False
    if remat in ("selective", "dots", "offload_dots"):
        not_ported(f"the remat policy {remat!r}", "queue 3: remat policies")
    raise ValueError(f"unknown remat policy {remat!r} (expected True/'full', "
                     "'dots', 'selective', 'offload_dots', False/'none')")


def run_layers(cfg: TransformerConfig, x, layer_params, positions, mask_bias,
               rng: Optional[torch.Generator] = None):
    """Run the layer blocks over ``x`` with the config's remat policy.
    ``rng`` (training loss paths only) seeds per-layer dropout; None keeps
    every path deterministic."""
    layers = list(layer_params)
    seeds = _seeds(rng if cfg.dropout else None, len(layers))
    full = _remat(cfg.remat)
    for lp, seed in zip(layers, seeds):
        if full:
            x = checkpoint(block, cfg, x, lp, positions, mask_bias, seed, use_reentrant=False)
        else:
            x = block(cfg, x, lp, positions, mask_bias, seed)
    return x


def hidden_states(cfg: TransformerConfig, params, tokens, attn_mask=None,
                  rng: Optional[torch.Generator] = None):
    """tokens ``[B, S]`` -> final normed hidden states ``[B, S, D]`` (the
    forward body without the vocab projection). ``rng`` enables dropout."""
    if cfg.norm_position == "post":
        raise ValueError("norm_position='post' is not supported by the LM "
                         "forward paths; use run_layers (e.g. BertModel)")
    B, S = tokens.shape
    tokens = tokens.long()
    x = params["embed"]["tokens"][tokens]
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    if cfg.pos_embedding == "learned":
        x = x + params["embed"]["positions"][:S][None, :, :]
    if cfg.embed_layernorm:
        x = _norm(cfg, x, params["embed"]["ln"])
    k_embed, k_layers = (_seeds(rng, 2) if cfg.dropout else (None, None))
    x = _dropout(cfg, x, _generator(k_embed, x.device))
    x = run_layers(cfg, x, params["layers"], positions, key_mask_bias(attn_mask),
                   rng=_generator(k_layers, "cpu"))
    return _norm(cfg, x, params["ln_f"])


def _head_bias(params):
    """Optional ``[vocab]`` logits bias (GPT-J's lm_head carries one)."""
    return params.get("lm_head_bias", 0)


def forward(cfg: TransformerConfig, params, tokens, attn_mask=None):
    """tokens ``[B, S]`` -> logits ``[B, S, vocab]``."""
    x = hidden_states(cfg, params, tokens, attn_mask)
    return x @ _head_weight(cfg, params) + _head_bias(params)


def _token_ce(logits, labels, valid):
    """Per-token nll sum and valid count from ``[N, V]`` fp32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def _chunk_ce(h, w, hb, labels, valid):
    return _token_ce((h @ w + hb).float(), labels, valid)


def chunked_vocab_ce(h, w, hb, safe_labels, valid, chunk: int):
    """Mean token cross-entropy for a vocab head ``h @ w + hb`` from
    ``[B, S, D]`` features. With ``chunk > 0`` dividing B*S, the projection
    and CE run over token chunks, each recomputed in the backward pass, so
    the ``[B, S, vocab]`` fp32 logits are never held at once."""
    B, S, D = h.shape
    vf = valid.to(torch.float32)
    if chunk <= 0 or (B * S) % chunk != 0:
        nll, n = _chunk_ce(h.reshape(B * S, D), w, hb, safe_labels.reshape(-1), vf.reshape(-1))
        return nll / torch.clamp(n, min=1)
    nc = (B * S) // chunk
    hf, lf, vff = h.reshape(nc, chunk, D), safe_labels.reshape(nc, chunk), vf.reshape(nc, chunk)
    nll = n = 0.0
    for i in range(nc):
        c_nll, c_n = checkpoint(_chunk_ce, hf[i], w, hb, lf[i], vff[i], use_reentrant=False)
        nll, n = nll + c_nll, n + c_n
    return nll / torch.clamp(n, min=1)


def _use_fused_ce(cfg, h) -> bool:
    """Whether the vocab head runs the fused logits-free CE kernels (K3).
    "on" always (the plain version for CPU tensors; fp32 on the card
    raises); "auto", like the JAX package's "accelerator and single
    device", when ``h`` lies on a CUDA device in fp16 / bf16 and no process
    group of more than one rank is up; "off" never."""
    mode = getattr(cfg, "fused_cross_entropy", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    if mode != "auto":
        raise ValueError(f"fused_cross_entropy={mode!r} (expected 'auto', 'on' or 'off')")
    dist = torch.distributed
    single = not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)
    return h.is_cuda and h.dtype in (torch.float16, torch.bfloat16) and single


def vocab_head_ce(cfg, h, w, hb, safe_labels, valid):
    """Mean token CE for a vocab head ``h @ w + hb``: the single dispatch
    every loss head goes through. The fused kernels (see
    :func:`_use_fused_ce`) never form the ``[tokens, vocab]`` logits;
    otherwise ``chunked_vocab_ce`` with ``cfg.loss_chunk``."""
    if _use_fused_ce(cfg, h):
        bias = None if isinstance(hb, (int, float)) else hb
        return fused_cross_entropy(h, w, safe_labels, bias=bias, valid=valid)
    return chunked_vocab_ce(h, w, hb, safe_labels, valid, getattr(cfg, "loss_chunk", 0))


def lm_loss(cfg: TransformerConfig, params, batch, rng: Optional[torch.Generator] = None,
            ignore_index: int = -100):
    """Next-token cross-entropy. batch: dict(input_ids ``[B, S]``, optional
    labels ``[B, S]`` (else the inputs shifted left, the last position
    ignored), optional attention_mask ``[B, S]``)."""
    tokens = batch["input_ids"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], ignore_index)], dim=1)
    x = hidden_states(cfg, params, tokens, batch.get("attention_mask"), rng=rng)
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    return vocab_head_ce(cfg, x, _head_weight(cfg, params), _head_bias(params), safe_labels,
                         valid)
