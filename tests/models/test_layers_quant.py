

def test_matmul_dtype_mixed_precision_mode():
    """QuantConfig.matmul_dtype='bfloat16' (round 5): dots run in bf16
    with f32 accumulation; quantizer params/grads stay f32; logits stay
    f32 and track the f32-matmul run closely. The unquantized baseline is
    UNTOUCHED (its dot dtype semantics must not change: its bf16 dots stay
    bf16-in/bf16-out)."""
    import flax
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantized_vit_tpu.models import (QuantConfig, VisionTransformer,
                                          init_quant_params_tree)
    from quantized_vit_tpu.models.vit import ViTConfig

    imgs = jnp.array(
        np.random.default_rng(0).standard_normal((2, 32, 32, 3)),
        jnp.float32)
    outs = {}
    for md in (None, "bfloat16"):
        cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                        num_heads=2, num_classes=5,
                        quant=QuantConfig(enabled=True, matmul_dtype=md))
        m = VisionTransformer(cfg)
        p = init_quant_params_tree(flax.core.unfreeze(
            m.init(jax.random.PRNGKey(0), imgs)["params"]), 4.0)
        y = m.apply({"params": p}, imgs)
        assert y.dtype == jnp.float32
        g = jax.grad(lambda pp: jnp.sum(m.apply({"params": pp}, imgs)))(p)
        gd = g["blocks_0"]["attn"]["qkv"]["d_quant_act"]
        assert gd.dtype == jnp.float32  # quantizer grads stay f32
        assert np.isfinite(np.asarray(gd)).all()
        outs[str(md)] = np.asarray(y)
    rel = (np.abs(outs["None"] - outs["bfloat16"]).max()
           / max(np.abs(outs["None"]).max(), 1e-9))
    assert rel < 0.1, rel

    # unquantized baseline: dot output keeps the INPUT dtype (bf16 in,
    # bf16 out) regardless of matmul_dtype
    from quantized_vit_tpu.models.layers import QuantDense

    dl = QuantDense(features=16, config=QuantConfig.off())
    xb = jnp.ones((4, 8), jnp.bfloat16)
    pb = dl.init(jax.random.PRNGKey(0), xb)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pb)
    assert dl.apply(pb, xb).dtype == jnp.bfloat16
