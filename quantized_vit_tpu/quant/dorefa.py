"""DoReFa-style STE quantizers used by the UltraNet 4-bit CNN.

JAX re-design of the reference's `4-bit quantization/quant_ultra.py`:

- :func:`uniform_quantize` — ``round(x * n) / n`` with a straight-through
  gradient (quant_ultra.py:8-27). ``k == 32`` is identity, ``k == 1`` is sign.
- :func:`quantize_weight` — tanh soft-clip -> normalize to [-1, 1] -> signed
  ``(w_bit-1)``-level uniform quantization (quant_ultra.py:30-56).
- :func:`quantize_activation` — clamp to [0, 1] -> unsigned ``a_bit`` uniform
  quantization (quant_ultra.py:59-73).
- :func:`fold_batchnorm` — BN(γ, β, μ, σ², ε) folded to an affine (w, b) with
  the reference's exact (non-standard) ``γ/(sqrt(σ²)+ε)`` denominator
  (quant_ultra.py:111-112), then clamp/remap/quantize as the "quantized BN"
  layer does (quant_ultra.py:114-121).

All functions are pure; STE is expressed with ``jax.lax.stop_gradient`` rather
than a custom_vjp — ``x + sg(q(x) - x)`` has exactly the straight-through
Jacobian and fuses away under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ste(x: jax.Array, q: jax.Array) -> jax.Array:
    """Value of ``q``, gradient of identity w.r.t. ``x``."""
    return x + jax.lax.stop_gradient(q - x)


def uniform_quantize(x: jax.Array, k: int) -> jax.Array:
    """``round(x * (2^k - 1)) / (2^k - 1)`` with straight-through gradient."""
    if k == 32:
        return x
    if k == 1:
        return _ste(x, jnp.sign(x))
    n = float(2**k - 1)
    return _ste(x, jnp.round(x * n) / n)


def quantize_weight(w: jax.Array, w_bit: int) -> jax.Array:
    """DoReFa weight quantizer (quant_ultra.py:38-56).

    32-bit passes through; 1-bit scales by the mean |w| (detached); otherwise
    tanh -> /max|.| -> signed (w_bit-1)-bit uniform quantization.
    """
    if w_bit == 32:
        return w
    if w_bit == 1:
        e = jax.lax.stop_gradient(jnp.mean(jnp.abs(w)))
        return (uniform_quantize(w / e, 1) + 1.0) / 2.0 * e
    wt = jnp.tanh(w)
    wt = wt / jnp.max(jnp.abs(wt))
    return uniform_quantize(wt, w_bit - 1)


def quantize_activation(x: jax.Array, a_bit: int) -> jax.Array:
    """DoReFa activation quantizer: clamp [0,1] then unsigned a_bit levels."""
    if a_bit == 32:
        return x
    return uniform_quantize(jnp.clip(x, 0.0, 1.0), a_bit)


def quantize_weight_levels(w: jax.Array, w_bit: int) -> jax.Array:
    """Integer levels of :func:`quantize_weight`: int32 in ±(2^(w_bit-1)-1).

    ``quantize_weight(w, b) == quantize_weight_levels(w, b) / (2^(b-1)-1)``.
    Matches the export-side `4-bit quantization/quantization.py:24-31`.
    """
    wt = jnp.tanh(w)
    wt = wt / jnp.max(jnp.abs(wt))
    n = float(2 ** (w_bit - 1) - 1)
    return jnp.round(wt * n).astype(jnp.int32)


def quantize_activation_levels(x: jax.Array, a_bit: int) -> jax.Array:
    """Integer levels of :func:`quantize_activation`: uint levels in [0, 2^a-1]."""
    n = float(2**a_bit - 1)
    return jnp.round(jnp.clip(x, 0.0, 1.0) * n).astype(jnp.int32)


def fold_batchnorm_affine(gamma, beta, mean, var, eps):
    """Fold BN(γ, β, μ, σ², ε) into the affine (w, b) with the reference's
    exact (non-standard) ``γ/(sqrt(σ²)+ε)`` denominator
    (quant_ultra.py:111-112 / :195-196): the BN computes ``w * x + b``."""
    denom = jnp.sqrt(var) + eps
    w = gamma / denom
    b = beta - (mean / denom) * gamma
    return w, b


def fold_batchnorm(gamma, beta, mean, var, eps, w_bit: int):
    """Quantized-BN fold (quant_ultra.py:94-132): returns (w_q, b_q) such that
    the BN layer computes ``w_q * x + b_q``.

    Uses :func:`fold_batchnorm_affine`, then clamps both to [-1, 1], remaps
    to [0, 1], quantizes with ``w_bit`` unsigned levels and maps back to
    [-1, 1].
    """
    w, b = fold_batchnorm_affine(gamma, beta, mean, var, eps)
    w01 = jnp.clip(w, -1.0, 1.0) / 2.0 + 0.5
    b01 = jnp.clip(b, -1.0, 1.0) / 2.0 + 0.5
    w_q = 2.0 * uniform_quantize(w01, w_bit) - 1.0
    b_q = 2.0 * uniform_quantize(b01, w_bit) - 1.0
    return w_q, b_q
