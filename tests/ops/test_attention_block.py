"""The serving block's attention branch — LN + quant -> qkv matmul ->
attention (output quantized to proj's levels) -> proj + residual, as
serve/vit_int4.py:_vit_block chains it — against float64 math, across
weight formats, odd head counts, the t != 1 (pow) quantizers and the f32
parity configuration.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from quantized_vit_tpu.ops import attention_qkv_xla, fused_quant_matmul_xla
from quantized_vit_tpu.quant.packing import pack_int4


def _mk(b=2, n=32, heads=2, hd=64, d=128, seed=0):
    rng = np.random.default_rng(seed)
    three = 3 * heads * hd
    return dict(
        b=b, n=n, heads=heads, hd=hd, d=d, three=three,
        x=np.asarray(jnp.array(rng.standard_normal((b, n, d)) * 0.2,
                               jnp.bfloat16), np.float32),
        wq=rng.integers(-7, 8, (d, three)).astype(np.int8),
        qb=(rng.standard_normal(three) * 0.01).astype(np.float32),
        wp=rng.integers(-7, 8, (heads * hd, d)).astype(np.int8),
        pb=(rng.standard_normal(d) * 0.01).astype(np.float32),
        g=(rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32),
        be=(rng.standard_normal(d) * 0.01).astype(np.float32),
    )


def _chain(m, fmt="int8", act_pow=False, out_pow=False, nv=29,
           dtype=jnp.bfloat16):
    """The branch as the serving forward runs it."""
    pk = (lambda w: pack_int4(jnp.array(w), axis=0)) if fmt == "int4" \
        else jnp.array
    x2 = jnp.array(m["x"].reshape(m["b"] * m["n"], m["d"]), dtype)
    qkv = fused_quant_matmul_xla(
        x2, pk(m["wq"]), jnp.float32(1e-3), jnp.array(m["qb"]), fmt=fmt,
        prologue="ln_quant", act_d=jnp.float32(0.05),
        act_t=jnp.float32(1.08 if act_pow else 1.0), act_top=127,
        act_pow=act_pow, ln_scale=jnp.array(m["g"]),
        ln_bias=jnp.array(m["be"]), out_dtype=dtype)
    alv = attention_qkv_xla(
        qkv.reshape(m["b"], m["n"], m["three"]), heads=m["heads"],
        sm_scale=0.18, n_valid=nv, out_d=jnp.float32(0.06),
        out_t=jnp.float32(0.93 if out_pow else 1.0), out_top=31,
        out_pow=out_pow)
    out = fused_quant_matmul_xla(
        alv.reshape(m["b"] * m["n"], m["heads"] * m["hd"]), pk(m["wp"]),
        jnp.float32(2e-3), jnp.array(m["pb"]), fmt=fmt, prologue=None,
        epilogue="residual", residual=x2, out_dtype=dtype)
    return np.asarray(out, np.float64).reshape(m["b"], m["n"], m["d"])


def _oracle(m, act_pow=False, out_pow=False, nv=29):
    """float64 branch on the real tokens (pad keys dropped)."""
    t_a, t_o = (1.08 if act_pow else 1.0), (0.93 if out_pow else 1.0)

    def quant(x, d, t, top):
        return np.sign(x) * np.minimum(np.round(np.abs(x) ** t / d), top)

    b, n, heads, hd = m["b"], m["n"], m["heads"], m["hd"]
    x = m["x"].astype(np.float64)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    h = (x - mu) / np.sqrt(var + 1e-6) * m["g"] + m["be"]
    qkv = quant(h, 0.05, t_a, 127) @ m["wq"].astype(np.float64) * 1e-3
    qkv = (qkv + m["qb"]).reshape(b, n, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :nv, 1], qkv[:, :nv, 2]
    s = np.einsum("bnhd,bmhd->bhnm", q, k) * 0.18
    p = np.exp(s - s.max(-1, keepdims=True))
    o = np.einsum("bhnm,bmhd->bnhd", p / p.sum(-1, keepdims=True), v)
    alv = quant(o.reshape(b, n, heads * hd), 0.06, t_o, 31)
    return x + alv @ m["wp"].astype(np.float64) * 2e-3 + m["pb"]


def _assert_branch_close(got, want, m, upd_rel, max_abs):
    """The branch update (output - x) against float64, in relative L2, and
    the largest output error. In bf16 the chain rounds q, k, v and p, which
    flips some proj-input levels at rounding ties; one flip moves an output
    by 2e-3 * |w| <= 0.014."""
    x = m["x"].astype(np.float64)
    u, v = got - x, want - x
    assert np.linalg.norm(u - v) <= upd_rel * np.linalg.norm(v), (
        np.linalg.norm(u - v) / np.linalg.norm(v))
    assert np.abs(got - want).max() <= max_abs, np.abs(got - want).max()


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_attention_qkv_proj_matches_chain(fmt):
    m = _mk()
    got = _chain(m, fmt=fmt)
    _assert_branch_close(got, _oracle(m), m, upd_rel=0.05, max_abs=0.1)
    np.testing.assert_array_equal(got, _chain(m, fmt="int8"))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("pow_", [False, True])
def test_attention_block_matches_chain(fmt, pow_):
    m = _mk(heads=3, hd=32, d=96)  # odd head count, compressed-subnet case
    got = _chain(m, fmt=fmt, act_pow=pow_, out_pow=pow_)
    _assert_branch_close(got, _oracle(m, act_pow=pow_, out_pow=pow_), m,
                         upd_rel=0.05, max_abs=0.1)


def test_attention_block_f32_matches_f32_chain():
    """float_dtype=f32 (strict-parity config): the chain agrees with
    float64 math to f32 rounding (no level flips at these inputs)."""
    m = _mk()
    _assert_branch_close(_chain(m, dtype=jnp.float32), _oracle(m), m,
                         upd_rel=1e-6, max_abs=1e-5)
