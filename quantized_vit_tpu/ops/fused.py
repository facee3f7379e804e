"""Quantized matmul with fused prologue/epilogue, as plain XLA.

- ``fused_quant_matmul_xla``: int4/int8 weight matmul with
  * prologue  ``None`` (x already int8 levels) | ``'quant'`` (LSFQ activation
    quantization of float x) | ``'ln_quant'`` (LayerNorm, then quantization
    — the pre-norm ViT block reads the residual stream once);
  * epilogue  dequant ``acc*scale+bias`` always, then optionally
    ``residual`` add (emits the new residual stream) or
    ``'quant'``/``'gelu_quant'`` (emits the NEXT layer's int8 levels, so the
    consumer runs prologue-free and inter-layer traffic is int8).
- ``fused_mlp_xla``: the whole MLP branch as two such calls.

The elementwise prologue and epilogue are left to XLA's fusion; the int8
dot accumulates in int32 (``preferred_element_type``). The reference
quantizes exactly the Linear/Conv inputs and weights (quant_layers.py:575-587);
LayerNorm/softmax/GELU/residual stay float. The level computation is f32
with the clip(round(|x|^t/d), top) form (see quant/lsfq.py for why
clip-round equals the reference's masked min form).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _quantize_f32(x, d, t, top, act_pow: bool, folded: bool = False):
    """LSFQ levels: clip(round(|x|^t / d), -top, top) * sign, f32 math.

    Equal to the reference's masked form sign(x)*min(round(|x|^t/d), top)
    with the |x|>=q_m clamp, because round is monotone and symmetric (RTNE)
    and top = round((q_m^t - q_s)/d) — see quant/lsfq.py:lsfq_top_level.

    ``folded``: the caller already multiplied 1/d into x's affine producer
    (LN gamma/beta or the dequant scale/bias), so the per-element multiply
    is skipped. ``top`` may be a Python number or a traced array.
    """
    x = x.astype(jnp.float32)
    top_f = (jnp.float32(top) if isinstance(top, (int, float))
             else top.astype(jnp.float32))
    if act_pow:
        x_abs = jnp.abs(x)
        p = jnp.exp(t * jnp.log(jnp.maximum(x_abs, 1e-30)))
        lv = jnp.sign(x) * jnp.minimum(jnp.round(p / d), top_f)
    elif folded:
        lv = jnp.clip(jnp.round(x), -top_f, top_f)
    else:
        lv = jnp.clip(jnp.round(x * (1.0 / d)), -top_f, top_f)
    return lv.astype(jnp.int8)


def _layernorm_f32(x, gamma, beta, eps):
    """LayerNorm in f32, fast-variance form (matches flax.linen.LayerNorm)."""
    x32 = x.astype(jnp.float32)
    inv_k = 1.0 / float(x.shape[-1])
    mu = jnp.sum(x32, axis=-1, keepdims=True) * inv_k
    mean2 = jnp.sum(jnp.square(x32), axis=-1, keepdims=True) * inv_k
    var = jnp.maximum(mean2 - jnp.square(mu), 0.0)
    return (x32 - mu) * jax.lax.rsqrt(var + eps) * gamma + beta


def _gelu_f32(x):
    # exact (erf) GELU, as nn.gelu(approximate=False)
    return x * 0.5 * (1.0 + jax.lax.erf(x * (2.0**-0.5)))


_SQRT2 = 2.0**0.5


def _gelu_quant_folded(z, d, top):
    """round(GELU(y)/d) levels from z = y/sqrt(2) in one fused chain.

    The caller folds 1/sqrt(2) into the dequant scale/bias so this
    receives z directly; GELU(y)/d = w + w*erf(z) with w = z*sqrt(2)/(2d).
    Saves the y-recovery and the quantizer's 1/d multiply vs
    gelu-then-quantize, and the fma form saves the (1 + e) add.
    """
    e = jax.lax.erf(z)
    c2 = _SQRT2 * 0.5 / d  # scalar
    top_f = (jnp.float32(top) if isinstance(top, (int, float))
             else top.astype(jnp.float32))
    w = z * c2
    lv = jnp.clip(jnp.round(w + w * e), -top_f, top_f)
    return lv.astype(jnp.int8)


def fused_mlp_xla(x, w1, scale1, bias1, w2, scale2, bias2, *,
                  ln_scale, ln_bias, ln_eps=1e-6,
                  act_d=None, act_t=None, act_top=None, act_pow=False,
                  hid_d=None, hid_t=None, hid_top=None, hid_pow=False,
                  fmt="int8", fmt2=None, out_dtype=jnp.bfloat16):
    """The MLP branch of a pre-norm block: LN2 -> quant -> fc1 -> GELU ->
    quant to fc2's levels -> fc2 -> + x. The [M, hidden] tensor between the
    two matmuls is int8 levels. ``fmt`` is fc1's weight format and ``fmt2``
    fc2's (default: the same; mixed-precision exports can differ)."""
    hlv = fused_quant_matmul_xla(
        x, w1, scale1, bias1, fmt=fmt, prologue="ln_quant",
        act_d=act_d, act_t=act_t, act_top=act_top, act_pow=act_pow,
        ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
        epilogue="gelu_quant", out_d=hid_d, out_t=hid_t, out_top=hid_top,
        out_pow=hid_pow)
    return fused_quant_matmul_xla(
        hlv, w2, scale2, bias2, fmt=fmt2 or fmt, prologue=None,
        epilogue="residual", residual=x, out_dtype=out_dtype)


def fused_quant_matmul_xla(
    x, w, scale, bias=None, *, fmt="int4", prologue="quant",
    act_d=None, act_t=None, act_top=None, act_pow=False,
    ln_scale=None, ln_bias=None, ln_eps=1e-6,
    epilogue=None, residual=None,
    out_d=None, out_t=None, out_top=None, out_pow=False,
    out_dtype=jnp.bfloat16,
):
    """int4/int8 weight matmul with the prologue/epilogue described in the
    module docstring. 1/d is constant-folded into LN gamma/beta (prologue)
    and into the dequant scale/bias (epilogue) when the quantizer is
    linear (t == 1)."""
    from .reference import int4_matmul_ref, int8_matmul_ref

    scale = jnp.asarray(scale, jnp.float32)
    if bias is not None:
        bias = jnp.asarray(bias, jnp.float32)
    act_folded = prologue == "ln_quant" and not act_pow
    if act_folded:
        inv_d = 1.0 / jnp.asarray(act_d, jnp.float32)
        ln_scale = jnp.asarray(ln_scale, jnp.float32) * inv_d
        ln_bias = jnp.asarray(ln_bias, jnp.float32) * inv_d
    out_folded = epilogue in ("quant", "gelu_quant") and not out_pow
    if out_folded:
        f = (1.0 / jnp.asarray(out_d, jnp.float32) if epilogue == "quant"
             else jnp.float32(2.0**-0.5))
        scale = scale * f
        if bias is not None:
            bias = bias * f

    if prologue is None:
        lv = x
    else:
        xx = x
        if prologue == "ln_quant":
            xx = _layernorm_f32(xx, jnp.asarray(ln_scale, jnp.float32),
                                jnp.asarray(ln_bias, jnp.float32), ln_eps)
        lv = _quantize_f32(xx, jnp.asarray(act_d, jnp.float32),
                           jnp.asarray(act_t, jnp.float32),
                           jnp.asarray(act_top, jnp.int32), act_pow,
                           folded=act_folded)
    acc = int4_matmul_ref(lv, w) if fmt == "int4" else int8_matmul_ref(lv, w)
    out = acc.astype(jnp.float32) * jnp.broadcast_to(scale, (acc.shape[-1],))
    if bias is not None:
        out = out + bias
    if epilogue == "residual":
        return (out + residual.astype(jnp.float32)).astype(out_dtype)
    if epilogue == "gelu_quant" and out_folded:
        return _gelu_quant_folded(out, jnp.asarray(out_d, jnp.float32),
                                  jnp.asarray(out_top, jnp.int32))
    if epilogue in ("quant", "gelu_quant"):
        if epilogue == "gelu_quant":
            out = _gelu_f32(out)
        return _quantize_f32(out, jnp.asarray(out_d, jnp.float32),
                             jnp.asarray(out_t, jnp.float32),
                             jnp.asarray(out_top, jnp.int32), out_pow,
                             folded=out_folded)
    return out.astype(out_dtype)
