"""INT4 packing for the serving artifact.

Replaces the reference's FPGA SIMD bit-packing (`4-bit quantization/
qnn_mem_process.py:11-24` packs w_bit values LSB-first into `ap_uint` words
tiled [PE][TILES]). Here the layout is two int4 nibbles per int8 byte,
packed along the *contraction* dimension in halves:

    packed[k, n] = (W[k, n] & 0xF) | (W[k + K/2, n] << 4)

so that the unpack is two arithmetic shifts and a concat that produce
the original [K, N] row order:

    low  = (packed << 4) >> 4   # rows 0..K/2-1, sign-extended
    high = packed >> 4          # rows K/2..K-1, sign-extended
    W    = concat([low, high], axis=0)

Values must lie in [-8, 7]. LSFQ 4-bit levels lie in [-7, 7]; DoReFa 4-bit
levels lie in [-7, 7] — both fit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pack_int4(w: jax.Array, axis: int = 0) -> jax.Array:
    """Pack signed int4 values (in [-8, 7]) two-per-int8 along ``axis``.

    ``axis`` must have even length. Returns int8 with that axis halved:
    element i holds (w_i & 0xF) | (w_{i + len/2} << 4).
    """
    w = jnp.asarray(w)
    k = w.shape[axis]
    if k % 2:
        raise ValueError(f"pack axis length must be even, got {k}")
    w = jnp.moveaxis(w, axis, 0).astype(jnp.int8)
    lo = w[: k // 2]
    hi = w[k // 2 :]
    packed = (lo & jnp.int8(0x0F)) | (hi << 4).astype(jnp.int8)
    return jnp.moveaxis(packed, 0, axis)


def unpack_int4(packed: jax.Array, axis: int = 0) -> jax.Array:
    """Inverse of :func:`pack_int4`: int8 out, original axis length restored."""
    p = jnp.moveaxis(jnp.asarray(packed, jnp.int8), axis, 0)
    lo = ((p << 4).astype(jnp.int8) >> 4).astype(jnp.int8)  # sign-extend nibble
    hi = (p >> 4).astype(jnp.int8)
    out = jnp.concatenate([lo, hi], axis=0)
    return jnp.moveaxis(out, 0, axis)
