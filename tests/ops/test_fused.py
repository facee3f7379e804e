"""Fused quantized matmul (ops/fused.py) and attention (ops/attention.py)
against independent numpy oracles: float64 LayerNorm / LSFQ quantization /
GELU / softmax, integer matmul in int64, weights unpacked by numpy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from scipy.special import erf as np_erf

from quantized_vit_tpu.ops import (
    attention_qkv_xla,
    fused_mlp_xla,
    fused_quant_matmul_xla,
)
from quantized_vit_tpu.quant import pack_int4

M, K, N = 48, 64, 96


def _mk(seed=0, fmt="int4"):
    rng = np.random.default_rng(seed)
    x = jnp.array(rng.standard_normal((M, K)).astype(np.float32))
    w_lv = rng.integers(-7, 8, (K, N)).astype(np.int8)
    w = pack_int4(jnp.array(w_lv), axis=0) if fmt == "int4" else jnp.array(w_lv)
    scale = jnp.array(rng.random(N).astype(np.float32) * 0.01)
    bias = jnp.array(rng.standard_normal(N).astype(np.float32) * 0.1)
    act = dict(act_d=jnp.float32(0.05), act_t=jnp.float32(1.0),
               act_top=jnp.int32(7), act_pow=False)
    return rng, x, w, scale, bias, act, w_lv


def _np_quant(x, d, t=1.0, top=7):
    """LSFQ levels in float64: sign(x) * min(round(|x|^t / d), top)."""
    x = np.asarray(x, np.float64)
    return np.sign(x) * np.minimum(np.round(np.abs(x) ** t / d), top)


def _np_ln(x, g, b, eps=1e-6):
    x = np.asarray(x, np.float64)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * np.asarray(g) + np.asarray(b)


def _np_gelu(y):
    return y * 0.5 * (1.0 + np_erf(y / np.sqrt(2.0)))


def _np_linear(lv, w_lv, scale, bias=None):
    out = (np.asarray(lv, np.int64) @ np.asarray(w_lv, np.int64)
           ) * np.asarray(scale, np.float64)
    return out if bias is None else out + np.asarray(bias, np.float64)


def _level_close(got, want, max_frac=0.01):
    """int8 levels from f32 math vs a float64 oracle: equal except where
    the oracle's value lands within an f32 ulp of a rounding tie, where one
    level may flip."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= max_frac, (diff > 0).mean()


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_fused_quant_prologue_matches_xla(fmt):
    _, x, w, scale, bias, act, w_lv = _mk(fmt=fmt)
    got = fused_quant_matmul_xla(x, w, scale, bias, fmt=fmt,
                                 prologue="quant", **act,
                                 out_dtype=jnp.float32)
    want = _np_linear(_np_quant(x, 0.05), w_lv, scale, bias)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_fused_ln_quant_prologue_matches_xla():
    rng, x, w, scale, bias, act, w_lv = _mk(seed=1)
    g = jnp.array(rng.standard_normal(K).astype(np.float32) * 0.1 + 1.0)
    b = jnp.array(rng.standard_normal(K).astype(np.float32) * 0.1)
    kw = dict(fmt="int4", prologue="ln_quant", ln_scale=g, ln_bias=b,
              out_dtype=jnp.float32, **act)
    got = fused_quant_matmul_xla(x, w, scale, bias, **kw)
    want = _np_linear(_np_quant(_np_ln(x, g, b), 0.05), w_lv, scale, bias)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_fused_ln_matches_flax_layernorm():
    """The fast-variance LayerNorm of the prologue must track flax's
    LayerNorm: feed identity quantization so the only transform is LN."""
    import flax.linen as nn

    rng, x, w, scale, bias, act, _ = _mk(seed=2)
    g = jnp.array(rng.standard_normal(K).astype(np.float32) * 0.1 + 1.0)
    b = jnp.array(rng.standard_normal(K).astype(np.float32) * 0.1)
    ln = nn.LayerNorm(epsilon=1e-6)
    y_flax = ln.apply({"params": {"scale": g, "bias": b}}, x)
    from quantized_vit_tpu.ops.fused import _layernorm_f32

    y_mine = _layernorm_f32(x, g, b, 1e-6)
    np.testing.assert_allclose(np.asarray(y_mine), np.asarray(y_flax),
                               rtol=1e-5, atol=1e-5)


def test_fused_residual_epilogue():
    rng, x, w, scale, bias, act, w_lv = _mk(seed=3)
    x_lv = rng.integers(-7, 8, (M, K)).astype(np.int8)
    res = rng.standard_normal((M, N)).astype(np.float32)
    got = fused_quant_matmul_xla(
        jnp.array(x_lv), w, scale, bias, fmt="int4", prologue=None,
        epilogue="residual", residual=jnp.array(res), out_dtype=jnp.float32)
    want = _np_linear(x_lv, w_lv, scale, bias) + res
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("epi", ["quant", "gelu_quant"])
def test_fused_int8_emitting_epilogues(epi):
    _, x, w, scale, bias, act, w_lv = _mk(seed=4)
    kw = dict(fmt="int4", prologue="quant", **act, epilogue=epi,
              out_d=jnp.float32(0.02), out_t=jnp.float32(1.0),
              out_top=jnp.int32(127), out_pow=False)
    got = fused_quant_matmul_xla(x, w, scale, bias, **kw)
    assert got.dtype == jnp.int8
    y = _np_linear(_np_quant(x, 0.05), w_lv, scale, bias)
    if epi == "gelu_quant":
        y = _np_gelu(y)
    _level_close(got, _np_quant(y, 0.02, top=127))


def test_fused_nonlinear_act_pow():
    """t != 1 power-map quantization in the prologue."""
    _, x, w, scale, bias, _, w_lv = _mk(seed=5)
    act = dict(act_d=jnp.float32(0.05), act_t=jnp.float32(1.3),
               act_top=jnp.int32(31), act_pow=True)
    got = fused_quant_matmul_xla(x, w, scale, bias, fmt="int4",
                                 prologue="quant", **act,
                                 out_dtype=jnp.float32)
    want = _np_linear(_np_quant(x, 0.05, t=1.3, top=31), w_lv, scale, bias)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_fused_unaligned_k_padding():
    """K not a multiple of any tile size (40): LayerNorm statistics over
    the real K, packed int4 weights with an odd number of byte rows."""
    rng = np.random.default_rng(6)
    k = 40
    x = rng.standard_normal((16, k)).astype(np.float32)
    w_lv = rng.integers(-7, 8, (k, 32)).astype(np.int8)
    w = pack_int4(jnp.array(w_lv), axis=0)
    g = rng.standard_normal(k).astype(np.float32) * 0.1 + 1.0
    b = rng.standard_normal(k).astype(np.float32) * 0.1
    got = fused_quant_matmul_xla(
        jnp.array(x), w, jnp.float32(0.01), None, fmt="int4",
        prologue="ln_quant", ln_scale=jnp.array(g), ln_bias=jnp.array(b),
        act_d=jnp.float32(0.05), act_t=jnp.float32(1.0),
        act_top=jnp.int32(7), act_pow=False, out_dtype=jnp.float32)
    want = _np_linear(_np_quant(_np_ln(x, g, b), 0.05), w_lv, 0.01)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_erf_poly_accuracy():
    """The GELU+quantize epilogue (1/sqrt(2) folded into the dequant scale,
    exact erf) against float64 GELU then rounding: levels agree except at
    rounding ties."""
    from quantized_vit_tpu.ops.fused import _gelu_f32, _gelu_quant_folded

    y = np.linspace(-8.0, 8.0, 100001)
    np.testing.assert_allclose(
        np.asarray(_gelu_f32(jnp.array(y, jnp.float32))), _np_gelu(y),
        rtol=1e-6, atol=1e-6)
    d = 0.01
    got = _gelu_quant_folded(jnp.array(y / np.sqrt(2.0), jnp.float32),
                             jnp.float32(d), 127)
    _level_close(got, _np_quant(_np_gelu(y), d, top=127), max_frac=1e-3)


def _np_attention(qkv, heads, hd, sm_scale, n_valid):
    """float64 softmax attention over the real tokens (pad keys dropped)."""
    b = qkv.shape[0]
    x = np.asarray(qkv, np.float64)[:, :n_valid].reshape(
        b, n_valid, 3, heads, hd)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    s = np.einsum("bnhd,bmhd->bhnm", q, k) * sm_scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n_valid, heads * hd)


def test_attention_qkv_matches_xla_and_reference_math():
    rng = np.random.default_rng(7)
    b, n, heads, hd = 2, 32, 4, 16
    n_valid = 27
    qkv = rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)
    got = attention_qkv_xla(jnp.array(qkv), heads=heads, sm_scale=hd**-0.5,
                            n_valid=n_valid, out_dtype=jnp.float32)
    want = _np_attention(qkv, heads, hd, hd**-0.5, n_valid)
    np.testing.assert_allclose(np.asarray(got)[:, :n_valid], want,
                               rtol=1e-5, atol=1e-5)


def test_attention_qkv_quantized_output():
    rng = np.random.default_rng(8)
    b, n, heads, hd = 2, 16, 2, 8
    qkv = rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)
    got = attention_qkv_xla(
        jnp.array(qkv), heads=heads, sm_scale=hd**-0.5, n_valid=n,
        out_d=jnp.float32(0.01), out_t=jnp.float32(1.0),
        out_top=jnp.int32(127), out_pow=False)
    assert got.dtype == jnp.int8
    want = _np_quant(_np_attention(qkv, heads, hd, hd**-0.5, n), 0.01,
                     top=127)
    _level_close(got, want)


def test_attention_qkv_int8_matches_xla_and_tracks_float():
    """INT8 attention (dynamic per-head scales) stays close to float64
    softmax attention."""
    rng = np.random.default_rng(9)
    b, n, heads, hd = 2, 32, 4, 16
    qkv = rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)
    got = attention_qkv_xla(jnp.array(qkv), heads=heads, sm_scale=hd**-0.5,
                            n_valid=27, int_attention=True,
                            out_dtype=jnp.float32)
    want = _np_attention(qkv, heads, hd, hd**-0.5, 27)
    np.testing.assert_allclose(np.asarray(got)[:, :27], want, atol=0.05)


def test_vit_forward_int_attention_close_to_float_attention():
    """End-to-end: the INT8-attention serving path deviates only by the
    attention quantization error."""
    import flax
    from quantized_vit_tpu.models import (QuantConfig, ViTConfig,
                                          VisionTransformer,
                                          init_quant_params_tree)
    from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=4, num_classes=10,
                    quant=QuantConfig(enabled=True))
    model = VisionTransformer(cfg)
    x = jnp.array(np.random.default_rng(3).standard_normal((2, 32, 32, 3)),
                  jnp.float32)
    params = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(0), x)["params"])
    params = init_quant_params_tree(params, init_bits=4.0)
    art = export_vit_int4(cfg, params)
    y_f = np.asarray(vit_int4_forward(art, x, cfg))
    y_i = np.asarray(vit_int4_forward(art, x, cfg, int_attention=True))
    # the int8 attention error is often absorbed entirely by the downstream
    # int4 activation quantization (W4A4: only ~15 levels) — identical
    # outputs are expected at 4 bits; just bound the deviation
    np.testing.assert_allclose(y_i, y_f, rtol=0.08, atol=0.08)


def _mlp_case(rng, fmt, m, k, hid, pow_):
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    w1 = rng.integers(-7, 8, (k, hid)).astype(np.int8)
    w2 = rng.integers(-7, 8, (hid, k)).astype(np.int8)
    b1 = (rng.standard_normal(hid) * 0.01).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.01).astype(np.float32)
    g = (rng.standard_normal(k) * 0.1 + 1.0).astype(np.float32)
    be = (rng.standard_normal(k) * 0.01).astype(np.float32)
    t_a, t_h = (1.08, 0.93) if pow_ else (1.0, 1.0)
    pk = (lambda w: pack_int4(jnp.array(w), axis=0)) if fmt == "int4" \
        else jnp.array
    got = fused_mlp_xla(
        jnp.array(x), pk(w1), jnp.float32(1e-3), jnp.array(b1),
        pk(w2), jnp.float32(1e-3), jnp.array(b2),
        ln_scale=jnp.array(g), ln_bias=jnp.array(be),
        act_d=jnp.float32(0.05), act_t=jnp.float32(t_a), act_top=127,
        act_pow=pow_, hid_d=jnp.float32(0.05), hid_t=jnp.float32(t_h),
        hid_top=127, hid_pow=pow_, fmt=fmt, out_dtype=jnp.float32)
    lv = _np_quant(_np_ln(x, g, be), 0.05, t=t_a, top=127)
    h = _np_gelu(_np_linear(lv, w1, 1e-3, b1))
    want = x + _np_linear(_np_quant(h, 0.05, t=t_h, top=127), w2, 1e-3, b2)
    return np.asarray(got, np.float64), want


def test_fused_mlp_chunked_matches_resident_and_xla():
    """The whole MLP branch (LN -> quant -> fc1 -> GELU -> quant -> fc2 ->
    + x) against float64 math, linear and pow-map (t != 1) quantizers. A
    hidden level flipped at a rounding tie moves an output by at most
    scale2 * |w2| = 7e-3."""
    rng = np.random.default_rng(3)
    for pow_ in (False, True):
        got, want = _mlp_case(rng, "int8", 96, 128, 512, pow_)
        diff = np.abs(got - want)
        assert (diff > 1e-5).mean() <= 0.01, (pow_, (diff > 1e-5).mean())
        assert diff.max() <= 0.02, (pow_, diff.max())


def test_fused_mlp_resident_matches_xla():
    """Packed-int4 and unpacked-int8 storage of the same levels give the
    same MLP branch bit for bit."""
    for m, k, hid in ((448, 128, 512), (96, 256, 512)):
        g4, _ = _mlp_case(np.random.default_rng(7), "int4", m, k, hid, False)
        g8, _ = _mlp_case(np.random.default_rng(7), "int8", m, k, hid, False)
        np.testing.assert_array_equal(g4, g8)
