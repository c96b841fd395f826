"""Quantize-on-load for inference checkpoints: the port of
``deepspeed_tpu/runtime/weight_quantizer.py``.

Quantization runs AFTER name-mapping, on the port's ``[in, out]`` param
tree (one sub-tree per layer): quantizing the raw torch-layout state dict
would group the scales along the wrong axis once the ingestion transpose
runs. Weights become :class:`deepspeed_tpu_torch.ops.quant.Quantized8`
leaves (int8 payload and per-group fp32 scales) that each matmul site
dequantizes at use.
"""

from __future__ import annotations

from deepspeed_tpu_torch.ops.quant import quantize_leaves

# the matmul leaves under "layers" (ops.quant._QUANTIZABLE, split by kind)
_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_MLP_KEYS = ("w_gate", "w_up", "w_down", "res_w_up", "res_w_down")


class WeightQuantization:
    """Quantize a param tree's matmul weights on load.

    ``mlp_extra_grouping`` doubles the group count of the MLP matrices (the
    reference's ``is_mlp`` heuristic, keyed by the tree position as the JAX
    package keys it)."""

    def __init__(self, mlp_extra_grouping: bool = True):
        self.mlp_extra_grouping = mlp_extra_grouping

    def quantize_params(self, params, quantize_bits: int = 8, groups: int = 64,
                        include_head: bool = False):
        if quantize_bits != 8:
            raise NotImplementedError(
                f"quantize-on-load supports 8 bits (got {quantize_bits}); "
                "use runtime.quantize (MoQ) or compression for other widths")

        def groups_of(key):
            return groups * 2 if self.mlp_extra_grouping and key in _MLP_KEYS else groups

        return quantize_leaves(params, groups_of, include_head, groups)
