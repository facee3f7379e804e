"""Quantized compute of the serving path, as plain jax.numpy/lax for XLA."""

from .fused import fused_mlp_xla, fused_quant_matmul_xla
from .attention import attention_qkv_xla
from .reference import int4_matmul_ref, int8_matmul_ref, quant_linear_ref

__all__ = [
    "fused_quant_matmul_xla",
    "fused_mlp_xla",
    "attention_qkv_xla",
    "int4_matmul_ref",
    "int8_matmul_ref",
    "quant_linear_ref",
]
