"""UltraNet + ViT artifact pipelines: export -> save -> load -> run parity."""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.artifact import (
    UltraNetExportConfig,
    generate_ultranet_config,
    save_ultranet_artifact,
    load_ultranet_artifact,
    save_vit_int4_artifact,
    load_vit_int4_artifact,
)
from quantized_vit_tpu.models import UltraNet, UltraNetInt, ULTRANET_LAYERS


def _trained_like_ultranet(seed=0):
    """Random params with realistic BN stats (reference checkpoints have
    small running stats; wild random BN amplifies int/float divergence)."""
    model = UltraNet()
    rng = np.random.default_rng(seed)
    x = jnp.array(rng.random((1, 32, 64, 3)).astype(np.float32))
    variables = model.init(jax.random.PRNGKey(seed), x)
    params = flax.core.unfreeze(variables["params"])
    stats = flax.core.unfreeze(variables["batch_stats"])
    for i in range(len(ULTRANET_LAYERS)):
        feat = params[f"conv_{i}"]["kernel"].shape[-1]
        stats[f"bn_{i}"]["mean"] = jnp.array(
            rng.normal(0, 0.05, feat).astype(np.float32))
        stats[f"bn_{i}"]["var"] = jnp.array(
            rng.uniform(0.5, 1.5, feat).astype(np.float32))
        params[f"bn_{i}"]["scale"] = jnp.array(
            rng.uniform(0.5, 1.5, feat).astype(np.float32))
        params[f"bn_{i}"]["bias"] = jnp.array(
            rng.normal(0, 0.1, feat).astype(np.float32))
    return model, params, stats, x


def test_ultranet_config_table_geometry():
    table = generate_ultranet_config(UltraNetExportConfig())
    assert len(table) == 9
    assert table[0]["in_shape"] == [160, 320, 3]
    assert table[0]["in_bit"] == 8 and table[1]["in_bit"] == 4
    # 4 maxpools halve twice each dimension: 160/16=10, 320/16=20
    assert table[-1]["out_shape"] == [10, 20, 36]
    assert table[-1]["k"] == 1 and table[-1]["out_bit"] == 32


def test_ultranet_artifact_roundtrip_runs_and_matches_direct_export(tmp_path):
    model, params, stats, x = _trained_like_ultranet()
    out = str(tmp_path / "ultranet_art")
    save_ultranet_artifact(out, params, stats)
    int_params, meta = load_ultranet_artifact(out)

    assert meta["model"] == "ultranet"
    assert meta["export"]["w_bit"] == 4
    # integer model runs on the loaded artifact
    x_lv = jnp.round(jnp.clip(x, 0, 1) * 255).astype(jnp.int32)
    int_model = UltraNetInt()
    io_i, p_i = int_model.apply({"params": int_params}, x_lv)
    assert np.isfinite(np.asarray(io_i)).all()

    # float path correlation (the artifact is a requant of the same net)
    io_f, p_f = model.apply({"params": params, "batch_stats": stats}, x)
    a, b = np.asarray(p_f).ravel(), np.asarray(p_i).ravel()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.85, corr  # matches test_ultranet_parity end-to-end bound


def test_vit_int4_artifact_roundtrip_forward_parity(tmp_path):
    from quantized_vit_tpu.models import (
        QuantConfig, ViTConfig, VisionTransformer, init_quant_params_tree)
    from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=2, num_classes=10,
                    quant=QuantConfig(enabled=True))
    model = VisionTransformer(cfg)
    rng = np.random.default_rng(3)
    x = jnp.array(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    params = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(0), x[:1])["params"])
    params = init_quant_params_tree(params, init_bits=4.0)

    art = export_vit_int4(cfg, params)
    logits_before = vit_int4_forward(art, x, cfg)

    out = str(tmp_path / "vit_art")
    save_vit_int4_artifact(out, art, cfg)
    art2, cfg2 = load_vit_int4_artifact(out)
    assert cfg2 == cfg
    logits_after = vit_int4_forward(art2, x, cfg2)
    np.testing.assert_allclose(np.asarray(logits_after),
                               np.asarray(logits_before),
                               rtol=1e-5, atol=1e-5)


def test_vit_int4_artifact_sharded_load(tmp_path, mesh8):
    from quantized_vit_tpu.models import (
        QuantConfig, ViTConfig, VisionTransformer, init_quant_params_tree)
    from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=1,
                    num_heads=2, num_classes=8,
                    quant=QuantConfig(enabled=True))
    model = VisionTransformer(cfg)
    rng = np.random.default_rng(4)
    x = jnp.array(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    params = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(0), x[:1])["params"])
    params = init_quant_params_tree(params, init_bits=4.0)
    art = export_vit_int4(cfg, params)
    want = vit_int4_forward(art, x, cfg)

    out = str(tmp_path / "vit_art_sh")
    save_vit_int4_artifact(out, art, cfg)
    art2, cfg2 = load_vit_int4_artifact(out, mesh=mesh8)

    # qkv weight must actually be sharded over the model axis: each device
    # holds 1/4 of the output columns
    qkv_w = art2["blocks"][0]["qkv"].w
    shard_shape = qkv_w.addressable_shards[0].data.shape
    assert shard_shape[1] == qkv_w.shape[1] // 4, shard_shape
    with mesh8:
        got = vit_int4_forward(art2, x, cfg2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
