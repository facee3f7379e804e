"""Integer export math: weight levels, BN folding, integer inc/bias tables.

JAX re-design of `4-bit quantization/quantization.py` — the numpy
export-side re-implementation of the training quantizer. These functions
produce the integer tensors the integer inference path and the artifact
pipeline consume; every formula matches the reference bit-for-bit (verified
in tests/quant/test_integer.py against the reference semantics).

The key trick (quantization.py:68-89): the (BN + activation-quant) pair after
an integer conv is an *arithmetic progression threshold* — hardware only needs
an integer multiply-accumulate ``acc * inc + bias`` followed by a right shift,
where ``inc``/``bias`` were amplified by ``2^l_shift`` so the float scale
survives integer rounding.
"""

from __future__ import annotations

import jax.numpy as jnp


def uniform_quantize(x, bit: int = 2):
    """``round(x * n) / n`` with ``n = 2^bit - 1`` (quantization.py:5-9)."""
    n = float(2**bit - 1)
    return jnp.round(x * n) / n


def weight_quantize_float(x, bit: int = 2):
    """tanh -> normalize -> (bit-1)-level quantize (quantization.py:13-19)."""
    w = jnp.tanh(x)
    w = w / jnp.max(jnp.abs(w))
    return uniform_quantize(w, bit=bit - 1)


def weight_quantize_int(x, bit: int = 2):
    """tanh -> normalize -> round to int32 in ±(2^(bit-1)-1)
    (quantization.py:24-31)."""
    w = jnp.tanh(x)
    w = w / jnp.max(jnp.abs(w))
    w = w * (2 ** (bit - 1) - 1)
    return jnp.round(w).astype(jnp.int32)


def bn_act_w_bias_float(gamma, beta, mean, var, eps):
    """Fold BN into float (w, b): ``w = γ/(sqrt(σ²)+ε)``,
    ``b = β - μ/(sqrt(σ²)+ε)·γ`` (quantization.py:34-46; note the reference's
    nonstandard ``sqrt(var)+eps`` denominator, reproduced deliberately)."""
    denom = jnp.sqrt(var) + eps
    w = gamma / denom
    b = beta - (mean / denom) * gamma
    return w, b


def bn_act_quantize_int(
    gamma, beta, mean, var, eps, w_bit=2, in_bit=4, out_bit=4, l_shift=4
):
    """Integer (inc, bias) for fused BN+activation-requant
    (quantization.py:68-89).

    With ``n = 2^(w_bit-1+in_bit+l_shift) / ((2^(w_bit-1)-1)(2^in_bit-1))``:
      ``inc  = round((2^out_bit - 1) * n * w)``
      ``bias = round((2^(w_bit-1)-1)(2^in_bit-1)(2^out_bit-1) * n * b)``
    Downstream, an int accumulator ``acc`` requantizes as
    ``clip(round_shift(acc * inc + bias, total_shift), 0, 2^out_bit-1)``.
    """
    w, b = bn_act_w_bias_float(gamma, beta, mean, var, eps)
    n = 2 ** (w_bit - 1 + in_bit + l_shift) / (
        (2 ** (w_bit - 1) - 1) * (2**in_bit - 1)
    )
    inc_q = jnp.round((2**out_bit - 1) * n * w).astype(jnp.int32)
    bias_q = jnp.round(
        (2 ** (w_bit - 1) - 1) * (2**in_bit - 1) * (2**out_bit - 1) * n * b
    ).astype(jnp.int32)
    return inc_q, bias_q


def requantize_int(acc, inc, bias, w_bit=4, in_bit=4, out_bit=4, l_shift=4):
    """Integer requantization applying the (inc, bias) progression.

    ``acc`` is the int32 conv accumulator over integer weight levels
    (±(2^(w_bit-1)-1)) and integer input levels ([0, 2^in_bit-1]). Returns the
    next layer's unsigned ``out_bit`` input levels. The divisor
    ``2^(w_bit-1+in_bit+l_shift)·(2^out_bit-1)`` inverts the amplification
    baked into ``inc``/``bias`` and the output grid's own denominator, i.e. it
    reproduces ``round(clip(bn(acc·s_w·s_in), 0, 1)·(2^out_bit-1))`` in pure
    integer arithmetic (the FPGA-side compare/shift loop the reference's HLS
    headers drive; see SURVEY.md §3.6).
    """
    shift = w_bit - 1 + in_bit + l_shift
    scaled = acc.astype(jnp.int64) * inc.astype(jnp.int64) + bias.astype(jnp.int64)
    # inc/bias carry 2^shift amplification AND the (2^out_bit - 1) output-grid
    # multiplier; divide out only the amplification so the result lands on the
    # output level grid directly.
    denom = 2**shift
    out = jnp.floor_divide(scaled + denom // 2, denom)
    return jnp.clip(out, 0, 2**out_bit - 1).astype(jnp.int32)
