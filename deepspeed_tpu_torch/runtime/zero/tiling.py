"""TiledLinear: a large linear split into a grid of small tiles
(counterpart of ``deepspeed_tpu/runtime/zero/tiling.py``).

Reference parity: ``deepspeed/runtime/zero/tiling.py:36`` (``TiledLinear``
splits ``Linear(in, out)`` into ``in_splits × out_splits`` sub-linears so
ZeRO-3 fetches one small tile at a time instead of materialising the full
weight).

As in the JAX package, the tiles live as ONE stacked leaf
``w [out_splits, in_splits, in/in_splits, out/out_splits]`` under the same
key names (``w``, ``b``), so a JAX parameter tree loads unchanged. The
forward has the JAX package's two lowerings:

- ``scan_tiles=False`` (default): one ``torch.einsum`` over the whole grid;
- ``scan_tiles=True``: a loop over the out-split dim, one row of tiles
  ``w[o]`` a step (the JAX ``lax.scan``), so a sharded leading dim would be
  gathered one row at a time. On one card it computes the same product.

The product is a plain matmul, which the JAX package leaves to XLA outside
any Pallas kernel; here it goes to ``torch.einsum`` (cuBLAS on the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.utils.init_on_device import honors_on_device


class TiledLinear:
    """y = x @ W + b with W stored as an [out_splits, in_splits] tile grid.

    ``in_features`` must divide by ``in_splits`` and ``out_features`` by
    ``out_splits`` (the reference round-robins remainders; uneven splits
    raise, as in the JAX package).
    """

    def __init__(self, in_features: int, out_features: int,
                 in_splits: int = 1, out_splits: int = 1,
                 bias: bool = True, scan_tiles: bool = False):
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(
                f"TiledLinear: {in_features}x{out_features} not divisible by "
                f"splits {in_splits}x{out_splits}")
        self.in_features = in_features
        self.out_features = out_features
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.tile_in = in_features // in_splits
        self.tile_out = out_features // out_splits
        self.use_bias = bias
        self.scan_tiles = scan_tiles

    # -------------------- params -------------------- #

    @honors_on_device
    def init_params(self, generator: Optional[torch.Generator] = None, device="cpu",
                    dtype=torch.float32) -> Dict[str, Any]:
        """N(0, 1/in_features) tiles and a zero bias, drawn from
        ``generator`` on ``device`` (values differ from ``jax.random``'s)."""
        scale = self.in_features**-0.5
        w = torch.randn((self.out_splits, self.in_splits, self.tile_in, self.tile_out),
                        generator=generator, device=device, dtype=torch.float32)
        p = {"w": (w * scale).to(dtype)}
        if self.use_bias:
            p["b"] = torch.zeros((self.out_features,), device=device, dtype=dtype)
        return p

    def from_dense(self, w, b=None) -> Dict[str, Any]:
        """Tile an existing dense ``w [in, out]`` (reference
        ``copy_params_from``)."""
        w = torch.as_tensor(w)
        if tuple(w.shape) != (self.in_features, self.out_features):
            raise ValueError(f"dense weight {tuple(w.shape)} != "
                             f"({self.in_features}, {self.out_features})")
        t = w.reshape(self.in_splits, self.tile_in, self.out_splits, self.tile_out)
        p = {"w": t.permute(2, 0, 1, 3).contiguous()}
        if self.use_bias:
            if b is None:
                raise ValueError("bias=True but no dense bias given")
            p["b"] = torch.as_tensor(b)
        return p

    def to_dense(self, params) -> torch.Tensor:
        return params["w"].permute(1, 2, 0, 3).reshape(self.in_features, self.out_features)

    # -------------------- forward -------------------- #

    def __call__(self, params, x):
        lead = tuple(x.shape[:-1])
        xt = x.reshape(lead + (self.in_splits, self.tile_in))
        w = params["w"]
        if self.scan_tiles:
            # one out-row of tiles a step: only w[o] is read while it is live
            ys = [torch.einsum("...it,itu->...u", xt, w[o]) for o in range(self.out_splits)]
            y = torch.stack(ys, dim=-2).reshape(lead + (self.out_features,))
        else:
            y = torch.einsum("...it,oitu->...ou", xt, w).reshape(lead + (self.out_features,))
        if self.use_bias:
            y = y + params["b"]
        return y
