"""LSFQ learned-scale symmetric quantizers as pure JAX functions.

JAX re-design of the reference's autograd quantizers
(reference: QViT_with_GETA/only_train_once/quantization/quant_layers.py:33-300):

- :func:`lsfq_nonlinear` — symmetric quantizer with nonlinear power mapping
  (learnable step ``d``, range ``q_m``, exponent ``t``); forward
  ``sign(x) * d * round(((|x|-q_s)^t)/d)`` clamped to 0 below ``q_s`` and to the
  top level at/above ``q_m``; hand-derived backward producing gradients for
  ``x`` (clipped STE), ``d`` (rounding-residual inner product), ``q_m`` and
  ``t``, matching quant_layers.py:71-125 mask precedence exactly.
- :func:`lsfq_linear` — same without the ``t`` exponent
  (quant_layers.py:128-205).
- :func:`dge` — differentiable-gradient-estimator variant replacing the STE
  input gradient with ``(1/k)|x - d/2|^(1/k-1)`` capped at +-3
  (quant_layers.py:208-290).

All quantizer state (``d``, ``q_m``, ``t``) are scalar jnp arrays; gradients
are sum-reduced to the same shape so these functions drop straight into a
params pytree. Unlike the reference there is no NaN-raising path inside the
backward (exceptions can't cross a jit boundary); use
:func:`quantized_vit_tpu.utils.guards.assert_finite_grads` at the host level
instead.

Inference-side integer helpers (:func:`lsfq_levels`, :func:`lsfq_dequant`)
express the same forward as an integer-level grid: because every quantized
value is an integer multiple of ``d``, ``sum((d_w i_w) * (d_a i_a)) =
d_w * d_a * sum(i_w i_a)`` holds for any ``t`` — this is what lets the serving
path run the matmul in int8/int4 with a single fused scale epilogue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-6  # matches the reference's log(|q_m - q_s| + 1e-6) guard


def _safe_pow(base: jax.Array, t: jax.Array) -> jax.Array:
    """exp(t*log(base)) with base clamped positive; caller masks invalid lanes."""
    return jnp.exp(t * jnp.log(jnp.maximum(base, 1e-30)))


# ---------------------------------------------------------------------------
# Nonlinear quantizer (learnable t)
# ---------------------------------------------------------------------------


@jax.custom_vjp
def lsfq_nonlinear(x, d, q_m, t, clip_val, q_s):
    """Symmetric nonlinear quantizer. ``clip_val`` is a (2,) array (lo, hi).

    Mask precedence mirrors quant_layers.py:62-68: the ``|x| >= q_m`` clamp is
    applied *after* the ``|x| <= q_s`` zeroing, so the clamp wins on overlap
    (reachable because ``q_m <= q_s`` can happen during training).
    """
    y, _ = _nonlinear_fwd(x, d, q_m, t, clip_val, q_s)
    return y


def _nonlinear_fwd(x, d, q_m, t, clip_val, q_s):
    x_abs = jnp.abs(x)
    range_pow = _safe_pow(jnp.abs(q_m - q_s) + _EPS, t)
    input_pow = _safe_pow(x_abs - q_s, t)
    base = d * jnp.round(input_pow / d)
    top = d * jnp.round(range_pow / d)
    y = jnp.where(x_abs <= q_s, 0.0, base)
    y = jnp.where(x_abs >= q_m, top, y)  # applied last -> wins on overlap
    y = jnp.sign(x) * y
    return y, (x, d, q_m, t, clip_val, q_s)


def _nonlinear_bwd(res, g):
    x, d, q_m, t, clip_val, q_s = res
    x_abs = jnp.abs(x)
    sgn = jnp.sign(x)

    # STE input gradient, zeroed outside the clip range (quant_layers.py:77-79)
    grad_x = jnp.where((x >= clip_val[1]) | (x <= clip_val[0]), 0.0, g)

    range_abs = jnp.abs(q_m - q_s) + _EPS
    range_pow = _safe_pow(range_abs, t)
    range_pow_low = _safe_pow(range_abs, t - 1.0)
    input_pow = _safe_pow(x_abs - q_s, t)

    # d gradient: rounding residual; note <=q_s zeroing is applied last here
    # (the reverse of the forward's precedence) — quant_layers.py:89-94.
    gd = jnp.round(input_pow / d) - input_pow / d
    gd = jnp.where(x_abs >= q_m, jnp.round(range_pow / d) - range_pow / d, gd)
    gd = jnp.where(x_abs <= q_s, 0.0, gd)
    grad_d = jnp.sum(g * sgn * gd).reshape(jnp.shape(d)).astype(jnp.result_type(d))

    # q_m gradient: only where |x| strictly exceeds q_m (quant_layers.py:97-99)
    gqm = jnp.where(x_abs <= q_m, 0.0, sgn * (t * range_pow_low))
    grad_qm = jnp.sum(g * gqm).reshape(jnp.shape(q_m)).astype(jnp.result_type(q_m))

    # t gradient (quant_layers.py:101-105); same mask precedence as grad_d
    gt = input_pow * jnp.log(jnp.maximum(x_abs - q_s, 1e-30))
    gt = jnp.where(x_abs >= q_m, range_pow * jnp.log(range_abs), gt)
    gt = jnp.where(x_abs <= q_s, 0.0, gt)
    grad_t = jnp.sum(g * sgn * gt).reshape(jnp.shape(t)).astype(jnp.result_type(t))

    return (
        grad_x,
        grad_d,
        grad_qm,
        grad_t,
        jnp.zeros_like(clip_val),
        jnp.zeros_like(q_s),
    )


lsfq_nonlinear.defvjp(_nonlinear_fwd, _nonlinear_bwd)


# ---------------------------------------------------------------------------
# Linear quantizer (t == 1)
# ---------------------------------------------------------------------------


@jax.custom_vjp
def lsfq_linear(x, d, q_m, clip_val, q_s):
    """Symmetric linear quantizer (quant_layers.py:128-205)."""
    y, _ = _linear_fwd(x, d, q_m, clip_val, q_s)
    return y


def _linear_fwd(x, d, q_m, clip_val, q_s):
    x_abs = jnp.abs(x)
    range_lin = jnp.abs(q_m - q_s)
    input_lin = x_abs - q_s
    base = d * jnp.round(input_lin / d)
    top = d * jnp.round(range_lin / d)
    y = jnp.where(x_abs <= q_s, 0.0, base)
    y = jnp.where(x_abs >= q_m, top, y)
    y = jnp.sign(x) * y
    return y, (x, d, q_m, clip_val, q_s)


def _linear_bwd(res, g):
    x, d, q_m, clip_val, q_s = res
    x_abs = jnp.abs(x)
    sgn = jnp.sign(x)

    grad_x = jnp.where((x >= clip_val[1]) | (x <= clip_val[0]), 0.0, g)

    range_lin = jnp.abs(q_m - q_s)
    input_lin = x_abs - q_s

    gd = jnp.round(input_lin / d) - input_lin / d
    gd = jnp.where(x_abs >= q_m, jnp.round(range_lin / d) - range_lin / d, gd)
    gd = jnp.where(x_abs <= q_s, 0.0, gd)
    grad_d = jnp.sum(g * sgn * gd).reshape(jnp.shape(d)).astype(jnp.result_type(d))

    # quant_layers.py:185-187: sign(x) where |x| > q_m, else 0
    gqm = jnp.where(x_abs <= q_m, 0.0, sgn)
    grad_qm = jnp.sum(g * gqm).reshape(jnp.shape(q_m)).astype(jnp.result_type(q_m))

    return grad_x, grad_d, grad_qm, jnp.zeros_like(clip_val), jnp.zeros_like(q_s)


lsfq_linear.defvjp(_linear_fwd, _linear_bwd)


# ---------------------------------------------------------------------------
# DGE quantizer (differentiable gradient estimation for the input)
# ---------------------------------------------------------------------------


@jax.custom_vjp
def dge(x, d, q_m, clip_val, q_s, num_bits):
    """DGE quantizer: linear forward, smooth input gradient
    ``(1/k)|x - d/2|^(1/k - 1)`` with ``k = 5 * 4 / num_bits``, capped at +-3
    (quant_layers.py:208-290)."""
    y, _ = _dge_fwd(x, d, q_m, clip_val, q_s, num_bits)
    return y


def _dge_fwd(x, d, q_m, clip_val, q_s, num_bits):
    y, _ = _linear_fwd(x, d, q_m, clip_val, q_s)
    return y, (x, d, q_m, clip_val, q_s, num_bits)


def _dge_bwd(res, g):
    x, d, q_m, clip_val, q_s, num_bits = res
    x_abs = jnp.abs(x)
    sgn = jnp.sign(x)
    k = 5.0 * (4.0 / num_bits)

    grad_x = jnp.where((x >= clip_val[1]) | (x <= clip_val[0]), 0.0, g)
    x_centered = x - d / 2.0
    grad_scale = (1.0 / k) * _safe_pow(jnp.abs(x_centered), 1.0 / k - 1.0)
    grad_x = jnp.clip(grad_x * grad_scale, -3.0, 3.0)

    range_lin = jnp.abs(q_m - q_s)
    input_lin = x_abs - q_s
    gd = jnp.round(input_lin / d) - input_lin / d
    gd = jnp.where(x_abs >= q_m, jnp.round(range_lin / d) - range_lin / d, gd)
    gd = jnp.where(x_abs <= q_s, 0.0, gd)
    grad_d = jnp.sum(g * sgn * gd).reshape(jnp.shape(d)).astype(jnp.result_type(d))

    gqm = jnp.where(x_abs <= q_m, 0.0, sgn)
    grad_qm = jnp.sum(g * gqm).reshape(jnp.shape(q_m)).astype(jnp.result_type(q_m))

    return (
        grad_x,
        grad_d,
        grad_qm,
        jnp.zeros_like(clip_val),
        jnp.zeros_like(q_s),
        jnp.zeros_like(num_bits),
    )


dge.defvjp(_dge_fwd, _dge_bwd)


# ---------------------------------------------------------------------------
# Integer-level views of the same forward (inference/export path)
# ---------------------------------------------------------------------------


def lsfq_levels(x, d, q_m, t, q_s=0.0):
    """Signed integer levels ``i`` such that ``lsfq_nonlinear(x,...) == d * i``.

    ``i = sign(x) * round(((|x|-q_s)^t)/d)`` with the same zero/clamp masks as
    the float forward. Output dtype int32; for <=8-bit configs the levels fit
    int8 and for <=4-bit configs they fit a packed int4 lane.
    """
    x_abs = jnp.abs(x)
    range_pow = _safe_pow(jnp.abs(q_m - q_s) + _EPS, t)
    input_pow = _safe_pow(x_abs - q_s, t)
    lvl = jnp.round(input_pow / d)
    top = jnp.round(range_pow / d)
    lvl = jnp.where(x_abs <= q_s, 0.0, lvl)
    lvl = jnp.where(x_abs >= q_m, top, lvl)
    lvl = jnp.minimum(lvl, top)  # numerical guard: never exceed the top level
    return (jnp.sign(x) * lvl).astype(jnp.int32)


def lsfq_top_level(d, q_m, t, q_s=0.0):
    """Number of positive levels ``L = round(((|q_m-q_s|+eps)^t)/d)``."""
    range_pow = _safe_pow(jnp.abs(q_m - q_s) + _EPS, t)
    return jnp.round(range_pow / d).astype(jnp.int32)


def lsfq_dequant(levels, d):
    """Exact inverse of :func:`lsfq_levels` into the float forward's codomain."""
    return levels.astype(jnp.result_type(d)) * d
