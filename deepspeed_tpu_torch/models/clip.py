"""CLIP text and vision encoders and the ``DSClipEncoder`` wrapper (the
port's copy of ``deepspeed_tpu/models/clip.py``).

The encoders are functional models over the shared backbone's pre-LN block
(QuickGELU, attention biases): the text tower causal with learned
positions, the vision tower non-causal over a class token and its patches.
On the card their attention runs kernel A. :class:`DSClipEncoder` holds both
towers and calls them eagerly under ``torch.no_grad``; the JAX package
compiles each branch once with ``jax.jit``, the counterpart of the
reference's per-branch CUDA graphs, which the port does not capture yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.utils.init_on_device import honors_on_device


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """The JAX package's ``CLIPTextConfig``. ``eos_token_id`` 2 (or None)
    pools at the argmax token id, HF's legacy rule (the end-of-text id is the
    largest of the CLIP vocabulary); any other id pools at its first
    occurrence."""
    vocab_size: int = 49408
    max_seq: int = 77
    n_layer: int = 12
    n_head: int = 8
    d_model: int = 512
    d_ff: int = 2048
    norm_eps: float = 1e-5
    projection_dim: Optional[int] = None
    activation: str = "quick_gelu"
    eos_token_id: Optional[int] = 2

    def zoo(self) -> T.TransformerConfig:
        return T.TransformerConfig(
            vocab_size=self.vocab_size, max_seq=self.max_seq,
            n_layer=self.n_layer, n_head=self.n_head, d_model=self.d_model,
            d_ff=self.d_ff, pos_embedding="learned", norm="layernorm",
            activation=self.activation, causal=True, attn_bias=True,
            norm_eps=self.norm_eps, tie_embeddings=True)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """The JAX package's ``CLIPVisionConfig``."""
    image_size: int = 224
    patch_size: int = 32
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    norm_eps: float = 1e-5
    projection_dim: Optional[int] = None
    activation: str = "quick_gelu"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def zoo(self) -> T.TransformerConfig:
        return T.TransformerConfig(
            vocab_size=1, max_seq=self.n_patches + 1, n_layer=self.n_layer,
            n_head=self.n_head, d_model=self.d_model, d_ff=self.d_ff,
            pos_embedding="none", norm="layernorm", activation=self.activation,
            causal=False, attn_bias=True, norm_eps=self.norm_eps,
            tie_embeddings=True)


def _normal(shape, std, generator, device, dtype):
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * std).to(dtype)


class CLIPTextEncoder(nn.Module):
    """HF ``CLIPTextModel`` semantics: a causal pre-LN transformer; the
    pooled output is the hidden state at each row's end-of-text token,
    through ``text_projection`` when the tree holds one."""

    def __init__(self, config: CLIPTextConfig, param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.zoo_cfg = config.zoo()
        self.param_dtype = param_dtype

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=None) -> T.ParamTree:
        dtype = self.param_dtype if dtype is None else dtype
        p = T.init_params(self.zoo_cfg, generator, device, dtype).to_dict()
        out = {"embed": p["embed"], "layers": p["layers"], "ln_f": p["ln_f"]}
        c = self.config
        if c.projection_dim:
            out["text_projection"] = _normal((c.d_model, c.projection_dim), c.d_model**-0.5,
                                             generator, device, dtype)
        return T.ParamTree(out)

    def forward(self, params, tokens, attn_mask=None):
        """The inference engine's surface: the last hidden states. CLIP pads
        with end-of-text tokens, so a padding mask is refused rather than
        ignored."""
        if attn_mask is not None:
            raise ValueError(
                "CLIPTextEncoder takes no padding mask (CLIP pads with EOT "
                "tokens); pass attention_mask=None")
        return self(params, tokens)[0]

    def __call__(self, params, tokens):
        """tokens ``[B, S]`` -> ``(last_hidden [B, S, D], pooled [B, D or
        projection_dim])``."""
        tokens = torch.as_tensor(tokens, device=params["embed"]["tokens"].device).long()
        x = T.hidden_states(self.zoo_cfg, params, tokens)
        eos = self.config.eos_token_id
        if eos is None or eos == 2:          # HF's legacy rule (see the config)
            eot = tokens.argmax(dim=-1)
        else:
            eot = (tokens == eos).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        if params.get("text_projection") is not None:
            pooled = pooled @ params["text_projection"]
        return x, pooled


class CLIPVisionEncoder(nn.Module):
    """HF ``CLIPVisionModel`` semantics: the conv patch embedding as a
    patchify and a matmul (NHWC), a class token, learned positions, a
    non-causal pre-LN transformer; the pooled output is the class token
    after ``ln_f``, through ``visual_projection`` when the tree holds one."""

    def __init__(self, config: CLIPVisionConfig, param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.zoo_cfg = config.zoo()
        self.param_dtype = param_dtype

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=None) -> T.ParamTree:
        c = self.config
        dtype = self.param_dtype if dtype is None else dtype
        p = T.init_params(self.zoo_cfg, generator, device, dtype).to_dict()
        patch_dim = 3 * c.patch_size * c.patch_size
        normal = lambda shape, std: _normal(shape, std, generator, device, dtype)
        out = {"patch_embed": normal((patch_dim, c.d_model), patch_dim**-0.5),
               "class_token": normal((c.d_model,), 0.02),
               "positions": normal((c.n_patches + 1, c.d_model), 0.02),
               "ln_pre": {"scale": torch.ones(c.d_model, device=device, dtype=dtype),
                          "bias": torch.zeros(c.d_model, device=device, dtype=dtype)},
               "layers": p["layers"], "ln_f": p["ln_f"]}
        if c.projection_dim:
            out["visual_projection"] = normal((c.d_model, c.projection_dim),
                                              c.d_model**-0.5)
        return T.ParamTree(out)

    def forward(self, params, tokens, attn_mask=None):
        """The engine's surface is token ids; a vision tower takes images."""
        raise ValueError(
            "CLIPVisionEncoder serves via __call__(params, images[B,H,W,3]), "
            "not the generic init_inference forward path")

    def _patchify(self, images):
        """``[B, H, W, 3]`` -> ``[B, n_patches, ps * ps * 3]`` (NHWC)."""
        ps = self.config.patch_size
        B, H, W, C = images.shape
        x = images.reshape(B, H // ps, ps, W // ps, ps, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // ps) * (W // ps), ps * ps * C)

    def __call__(self, params, images):
        """images ``[B, H, W, 3]`` -> ``(last_hidden [B, P + 1, D], pooled)``."""
        cfg, c = self.zoo_cfg, self.config
        w = params["patch_embed"]
        x = self._patchify(torch.as_tensor(images, device=w.device).to(w.dtype)) @ w
        cls = params["class_token"].expand(x.shape[0], 1, c.d_model)
        x = torch.cat([cls, x], dim=1) + params["positions"][None]
        x = T._norm(cfg, x, params["ln_pre"])
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        x = T.run_layers(cfg, x, params["layers"], positions, None)
        pooled = T._norm(cfg, x[:, 0], params["ln_f"])
        if params.get("visual_projection") is not None:
            pooled = pooled @ params["visual_projection"]
        return x, pooled


class DSClipEncoder(nn.Module):
    """Both CLIP towers behind ``encode_text`` / ``encode_image`` (the
    reference's ``DSClipEncoder``), each called eagerly without autograd."""

    def __init__(self, text: CLIPTextEncoder, vision: Optional[CLIPVisionEncoder] = None):
        super().__init__()
        self.text = text
        self.vision = vision

    def forward(self, params, tokens, attn_mask=None):
        """A two-tower CLIP has no single forward surface."""
        raise ValueError(
            "DSClipEncoder serves via encode_text(params['text'], tokens) / "
            "encode_image(params['vision'], images), not the generic "
            "init_inference forward path")

    @torch.no_grad()
    def encode_text(self, params, tokens):
        return self.text(params, tokens)

    @torch.no_grad()
    def encode_image(self, params, images):
        if self.vision is None:
            raise ValueError("no vision encoder configured")
        return self.vision(params, images)

