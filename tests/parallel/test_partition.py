"""GSPMD partition-rule tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from quantized_vit_tpu.parallel import (
    partition_specs,
    spec_for_path,
    shard_params,
    data_sharding,
)


def test_rules_map_expected_layers():
    assert spec_for_path("blocks_0/attn/qkv/kernel") == P(None, "model")
    assert spec_for_path("blocks_3/attn/proj/kernel") == P("model", None)
    assert spec_for_path("blocks_7/mlp/fc1/kernel") == P(None, "model")
    assert spec_for_path("blocks_7/mlp/fc2/kernel") == P("model", None)
    assert spec_for_path("blocks_0/mlp/fc1/bias") == P("model")
    # quant scalars, LN, embeddings replicated
    assert spec_for_path("blocks_0/attn/qkv/d_quant_wt") == P()
    assert spec_for_path("blocks_0/norm1/scale") == P()
    assert spec_for_path("pos_embed") == P()


def test_shard_params_places_on_mesh(mesh8):
    import flax
    from quantized_vit_tpu.models import QuantConfig, ViTConfig, VisionTransformer

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=1,
                    num_heads=4, num_classes=8,
                    quant=QuantConfig(enabled=True))
    model = VisionTransformer(cfg)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = flax.core.unfreeze(model.init(jax.random.PRNGKey(0), x)["params"])
    sharded = shard_params(params, mesh8)

    qkv = sharded["blocks_0"]["attn"]["qkv"]["kernel"]
    assert qkv.sharding.spec == P(None, "model")
    # 4-way model axis: each shard holds out_dim/4 columns
    assert qkv.addressable_shards[0].data.shape == (64, 192 // 4)

    proj = sharded["blocks_0"]["attn"]["proj"]["kernel"]
    assert proj.sharding.spec == P("model", None)
    assert proj.addressable_shards[0].data.shape == (64 // 4, 64)

    ln = sharded["blocks_0"]["norm1"]["scale"]
    assert ln.sharding.spec == P()


def test_sharded_forward_matches_single_device(mesh8):
    """TP+DP sharded ViT forward == replicated forward (GSPMD is a layout,
    not a numerics change)."""
    import flax
    from quantized_vit_tpu.models import QuantConfig, ViTConfig, VisionTransformer

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=4, num_classes=8, quant=QuantConfig.off())
    model = VisionTransformer(cfg)
    rng = np.random.default_rng(0)
    x = jnp.array(rng.standard_normal((4, 32, 32, 3)), jnp.float32)
    params = flax.core.unfreeze(model.init(jax.random.PRNGKey(0), x)["params"])

    y_single = np.asarray(model.apply({"params": params}, x))

    sharded = shard_params(params, mesh8)
    xs = jax.device_put(x, data_sharding(mesh8, x.ndim))
    fwd = jax.jit(lambda p, xb: model.apply({"params": p}, xb))
    with mesh8:
        y_sharded = np.asarray(fwd(sharded, xs))
    np.testing.assert_allclose(y_sharded, y_single, rtol=2e-5, atol=2e-5)


def test_dryrun_multichip_entrypoint():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
