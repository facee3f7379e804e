"""Attention of the ViT serving path, as plain XLA.

``attention_qkv_xla`` takes the fused qkv projection output [B, N, 3*H*hd]
and returns the attention output, optionally quantized to the proj layer's
int8 activation levels (the reference quantizes the proj input —
quant_layers.py:356-381 via vit_model.py:150-152 — so emitting levels here
keeps the same quantization surface and lets proj run prologue-free).

Padded key positions (the serving path pads 197 tokens up to a multiple of
16) are masked before the softmax, so padded tokens never leak into real
rows. Padded *query* rows produce values that the caller never reads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fused import _quantize_f32


_LOG2E = 1.4426950408889634


def attention_qkv_xla(qkv, *, heads, sm_scale, n_valid=None,
                      out_d=None, out_t=None, out_top=None, out_pow=False,
                      out_dtype=jnp.bfloat16, int_attention=False):
    """Softmax attention over the fused qkv tensor [B, N, 3*H*hd].

    The score and probability dots take qkv's dtype with f32 accumulation;
    an f32 qkv (the strict-parity configuration) runs them at HIGHEST
    precision, so a GPU does not round them to TF32. ``sm_scale*log2(e)`` is
    folded into q so the softmax uses exp2, and the row-sum division runs
    on the [N, hd] output instead of the [N, N] probabilities (folded into
    the quantizer's 1/d when ``out_d`` is given). ``int_attention``: score
    and AV dots on dynamically scaled int8 (per-(batch, head) scales)."""
    b, n, three_hdim = qkv.shape
    head_dim = three_hdim // (3 * heads)
    if n_valid is None:
        n_valid = n
    prec = (jax.lax.Precision.HIGHEST if qkv.dtype == jnp.float32
            else None)
    x = qkv.reshape(b, n, 3, heads, head_dim)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # [B, N, H, hd]
    if int_attention:
        def dyn(z):  # per-(b, h) scale over the (n, hd) axes
            z = z.astype(jnp.float32)
            s = jnp.maximum(jnp.max(jnp.abs(z), axis=(1, 3), keepdims=True),
                            1e-30) * (1.0 / 127.0)
            lv = jnp.clip(jnp.round(z * (1.0 / s)), -127.0, 127.0)
            return lv.astype(jnp.int8), s
        q_lv, q_s = dyn(q.astype(jnp.float32) * sm_scale)
        k_lv, k_s = dyn(k)
        s2 = jnp.einsum("bnhd,bmhd->bhnm", q_lv, k_lv,
                        preferred_element_type=jnp.int32).astype(jnp.float32)
        s2 = s2 * (jnp.transpose(q_s, (0, 2, 1, 3))
                   * jnp.transpose(k_s, (0, 2, 1, 3)) * _LOG2E)
    else:
        qs = (q.astype(jnp.float32) * (sm_scale * _LOG2E)).astype(q.dtype)
        s2 = jnp.einsum("bnhd,bmhd->bhnm", qs, k, precision=prec,
                        preferred_element_type=jnp.float32)
    if n_valid < n:
        col = jnp.arange(n)
        s2 = jnp.where(col[None, None, None, :] < n_valid, s2, -1e30)
    if int_attention:
        p = jnp.exp2(s2 - jnp.max(s2, axis=-1, keepdims=True))
    else:
        # Absolute exp2 with a fixed upper clamp instead of the row-max
        # subtraction: softmax is shift-invariant, so skipping it is exact
        # whenever s2 < 100 — LayerNorm-bounded ViT scores stay far below —
        # and at the clamp 2^100 * n_keys * |v|max stays far below the f32
        # max. An all-underflow row divides by the 1e-30 added to p_sum
        # below and yields 0 instead of NaN.
        p = jnp.exp2(jnp.minimum(s2, 100.0))
    if int_attention:
        p_lv = jnp.round(p * 127.0).astype(jnp.int8)
        v_lv, v_s = dyn(v)
        o_un = jnp.einsum("bhnm,bmhd->bnhd", p_lv, v_lv,
                          preferred_element_type=jnp.int32).astype(jnp.float32)
        o_un = o_un * v_s
        p_sum = jnp.sum(p_lv.astype(jnp.float32), axis=-1)
    else:
        pb = p.astype(qkv.dtype)
        o_un = jnp.einsum("bhnm,bmhd->bnhd", pb, v, precision=prec,
                          preferred_element_type=jnp.float32)
        p_sum = jnp.sum(p, axis=-1) + 1e-30
    p_sum = jnp.transpose(p_sum, (0, 2, 1))[..., None]
    if out_d is not None and not out_pow:
        lv = jnp.clip(
            jnp.round(o_un * (1.0 / (p_sum * jnp.asarray(out_d, jnp.float32)))),
            -jnp.asarray(out_top, jnp.float32), jnp.asarray(out_top, jnp.float32))
        return lv.astype(jnp.int8).reshape(b, n, heads * head_dim)
    o = (o_un / p_sum).reshape(b, n, heads * head_dim)
    if out_d is not None:
        return _quantize_f32(o, jnp.asarray(out_d, jnp.float32),
                             jnp.asarray(out_t, jnp.float32),
                             jnp.asarray(out_top, jnp.int32), out_pow)
    return o.astype(out_dtype)
