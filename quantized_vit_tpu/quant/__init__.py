"""Quantizer math: LSFQ learned-scale quantizers, DoReFa STE, integer export."""

from .lsfq import (
    lsfq_nonlinear,
    lsfq_linear,
    dge,
    lsfq_levels,
    lsfq_top_level,
    lsfq_dequant,
)
from .dorefa import (
    uniform_quantize,
    quantize_weight,
    quantize_activation,
    quantize_weight_levels,
    quantize_activation_levels,
    fold_batchnorm,
)
from .integer import (
    weight_quantize_float,
    weight_quantize_int,
    bn_act_w_bias_float,
    bn_act_quantize_int,
    requantize_int,
)
from .bitwidth import (
    bit_width,
    d_for_bits,
    init_quant_params,
    clip_transform,
    quant_residual,
    quantize_simple,
)
from .packing import pack_int4, unpack_int4

__all__ = [
    "lsfq_nonlinear",
    "lsfq_linear",
    "dge",
    "lsfq_levels",
    "lsfq_top_level",
    "lsfq_dequant",
    "uniform_quantize",
    "quantize_weight",
    "quantize_activation",
    "quantize_weight_levels",
    "quantize_activation_levels",
    "fold_batchnorm",
    "weight_quantize_float",
    "weight_quantize_int",
    "bn_act_w_bias_float",
    "bn_act_quantize_int",
    "requantize_int",
    "bit_width",
    "d_for_bits",
    "init_quant_params",
    "clip_transform",
    "quant_residual",
    "quantize_simple",
    "pack_int4",
    "unpack_int4",
]
