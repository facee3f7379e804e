"""Integer matmul primitives of the quantized compute ops.

They define the op contracts:

- activations enter as *integer levels* (int8) produced by
  :func:`quantized_vit_tpu.quant.lsfq.lsfq_levels` or the DoReFa level
  functions;
- weights are packed int4 (two nibbles per int8 along the contraction dim,
  :func:`quantized_vit_tpu.quant.packing.pack_int4`) or plain int8;
- the epilogue fuses ``acc * scale + bias`` where ``scale = d_w * d_a``
  (optionally per-output-channel) and ``bias`` absorbs the layer bias and any
  folded BN.

This mirrors what the reference computes in float fake-quant
(quant_layers.py:495-499 quantize->F.linear) — exact because every quantized
value is an integer multiple of its step size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..quant.packing import unpack_int4


def int4_matmul_ref(x_levels: jax.Array, w_packed: jax.Array) -> jax.Array:
    """int32 accumulator of ``x_levels @ unpack(w_packed)``.

    x_levels: [M, K] int8; w_packed: [K//2, N] int8 (packed int4). Out [M, N]
    int32.
    """
    w = unpack_int4(w_packed, axis=0)  # [K, N] int8
    return jax.lax.dot_general(
        x_levels,
        w,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def int8_matmul_ref(x_levels: jax.Array, w_levels: jax.Array) -> jax.Array:
    """int32 accumulator of ``x_levels @ w_levels`` (both int8)."""
    return jax.lax.dot_general(
        x_levels,
        w_levels,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def quant_linear_ref(acc: jax.Array, scale, bias=None, out_dtype=jnp.float32):
    """Dequant epilogue: ``acc * scale + bias`` (scale scalar or [N])."""
    out = acc.astype(jnp.float32) * scale
    if bias is not None:
        out = out + bias
    return out.astype(out_dtype)
