"""Integer matmul primitives (ops/reference.py) and the fused activation-
quant matmul (ops/fused.py) against independent numpy oracles: int64
accumulation with a nibble unpack written here, and float64 quantize math.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from quantized_vit_tpu.ops import (
    fused_quant_matmul_xla,
    int4_matmul_ref,
    int8_matmul_ref,
    quant_linear_ref,
)
from quantized_vit_tpu.quant import pack_int4


def _levels(shape, seed, lo=-7, hi=8):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=shape).astype(np.int8)


def _np_unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Oracle nibble unpack: byte k holds row k (low nibble) and row
    k + K/2 (high nibble), both sign-extended."""
    p = packed.astype(np.int64) & 0xFF
    lo = p & 0x0F
    hi = p >> 4
    lo = np.where(lo >= 8, lo - 16, lo)
    hi = np.where(hi >= 8, hi - 16, hi)
    return np.concatenate([lo, hi], axis=0)


def _np_acc(x_lv, w_lv) -> np.ndarray:
    return x_lv.astype(np.int64) @ w_lv.astype(np.int64)


@pytest.mark.parametrize(
    "m,k,n",
    [
        (8, 64, 128),       # tiny
        (197, 768, 768),    # ViT-B proj shape (unaligned M)
        (100, 250, 130),    # fully unaligned everything
    ],
)
def test_int4_matmul_matches_reference_exactly(m, k, n):
    k_even = k + (k % 2)
    x = _levels((m, k_even), seed=0)
    w = _levels((k_even, n), seed=1)
    w_packed = pack_int4(jnp.array(w), axis=0)
    rng = np.random.default_rng(2)
    scale = rng.random(n).astype(np.float32) * 0.01
    bias = rng.standard_normal(n).astype(np.float32)

    np.testing.assert_array_equal(_np_unpack_int4(np.asarray(w_packed)), w)
    acc = np.asarray(int4_matmul_ref(jnp.array(x), w_packed))
    assert acc.dtype == np.int32
    np.testing.assert_array_equal(acc, _np_acc(x, w))
    got = np.asarray(quant_linear_ref(jnp.asarray(acc), jnp.array(scale),
                                      jnp.array(bias)))
    want = _np_acc(x, w) * scale.astype(np.float64) + bias
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_int4_matmul_scalar_scale_no_bias():
    x = _levels((32, 128), seed=3)
    w = _levels((128, 64), seed=4)
    w_packed = pack_int4(jnp.array(w), axis=0)
    acc = int4_matmul_ref(jnp.array(x), w_packed)
    got = np.asarray(quant_linear_ref(acc, jnp.float32(0.02)))
    np.testing.assert_allclose(got, _np_acc(x, w) * 0.02, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (197, 768, 256)])
def test_int8_matmul_matches_reference_exactly(m, k, n):
    x = _levels((m, k), seed=5, lo=-127, hi=128)
    w = _levels((k, n), seed=6, lo=-127, hi=128)
    acc = np.asarray(int8_matmul_ref(jnp.array(x), jnp.array(w)))
    assert acc.dtype == np.int32
    np.testing.assert_array_equal(acc, _np_acc(x, w))


def test_int4_matmul_rejects_bad_dtypes_and_shapes():
    with pytest.raises(ValueError, match="even"):
        pack_int4(jnp.zeros((3, 8), jnp.int8), axis=0)
    with pytest.raises(TypeError):
        int4_matmul_ref(jnp.zeros((4, 8), jnp.int8),
                        jnp.zeros((3, 8), jnp.int8))


def test_full_lsfq_pipeline_through_kernel():
    """Float fake-quant linear == integer matmul on levels (the parity the
    ViT W4A4 path relies on): quantize weight+act with LSFQ, run the float
    matmul vs the int4 matmul with scale d_w*d_a."""
    from quantized_vit_tpu.quant import lsfq_nonlinear, init_quant_params
    from quantized_vit_tpu.quant.lsfq import lsfq_levels

    rng = np.random.default_rng(8)
    x = jnp.array(rng.standard_normal((64, 256)).astype(np.float32) * 0.5)
    w = jnp.array(rng.standard_normal((256, 128)).astype(np.float32) * 0.05)
    d_w, qm_w, t_w = init_quant_params(w, num_bits=4, nonlinear=True)
    d_a, qm_a, t_a = init_quant_params(x, num_bits=4, nonlinear=True)
    clip = jnp.array([-2.0, 2.0])
    q_s = jnp.array(0.0)

    w_q = lsfq_nonlinear(w, d_w, qm_w, t_w, clip, q_s)
    x_q = lsfq_nonlinear(x, d_a, qm_a, t_a, clip, q_s)
    float_out = np.asarray(x_q, np.float64) @ np.asarray(w_q, np.float64)

    w_lv = lsfq_levels(w, d_w, qm_w, t_w).astype(jnp.int8)
    x_lv = lsfq_levels(x, d_a, qm_a, t_a).astype(jnp.int8)
    w_packed = pack_int4(w_lv, axis=0)
    scale = (d_w * d_a)[0]
    int_out = quant_linear_ref(int4_matmul_ref(x_lv, w_packed), scale)

    np.testing.assert_allclose(
        np.asarray(int_out), float_out, rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("act_pow", [True, False])
def test_quant_matmul_fa_matches_unfused(fmt, act_pow):
    """Fused activation-quant matmul (prologue='quant') == quantize in
    float64, then integer matmul, then dequant."""
    rng = np.random.default_rng(11)
    m, k, n = 24, 64, 48
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_lv = _levels((k, n), seed=12, lo=-7, hi=8)
    d = 0.02
    t = 1.3 if act_pow else 1.0
    top = 127
    scale = rng.random(n).astype(np.float32) * 0.01
    bias = rng.standard_normal(n).astype(np.float32)

    p = np.abs(x.astype(np.float64)) ** t
    x_lv = np.sign(x) * np.minimum(np.round(p / d), top)
    want = _np_acc(x_lv, w_lv) * scale.astype(np.float64) + bias

    w = pack_int4(jnp.array(w_lv), axis=0) if fmt == "int4" else jnp.array(w_lv)
    got = np.asarray(fused_quant_matmul_xla(
        jnp.array(x), w, jnp.array(scale), jnp.array(bias), fmt=fmt,
        prologue="quant", act_d=jnp.float32(d), act_t=jnp.float32(t),
        act_top=top, act_pow=act_pow, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
