"""INT4 serving path parity: exported artifact forward == fake-quant forward.

BASELINE.json config 4 (ViT W4A4 full quantized inference): the integer
path must reproduce the float fake-quant model because LSFQ values are
integer multiples of d.
"""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.models import (
    QuantConfig,
    ViTConfig,
    VisionTransformer,
    init_quant_params_tree,
)
from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)


def _build(init_bits, nonlinear=True, seed=0):
    cfg = ViTConfig(
        quant=QuantConfig(enabled=True, nonlinear=nonlinear), **SMALL
    )
    model = VisionTransformer(cfg)
    x = jnp.array(
        np.random.default_rng(seed).standard_normal((2, 32, 32, 3)),
        jnp.float32,
    )
    params = flax.core.unfreeze(model.init(jax.random.PRNGKey(0), x)["params"])
    params = init_quant_params_tree(params, init_bits=init_bits)
    return cfg, model, params, x


@pytest.mark.parametrize("init_bits,expect_fmt", [(4.0, "int4"), (8.0, "int8")])
def test_export_fmt_selection(init_bits, expect_fmt):
    cfg, model, params, x = _build(init_bits)
    art = export_vit_int4(cfg, params)
    assert art["blocks"][0]["qkv"].fmt == expect_fmt
    if expect_fmt == "int4":
        # packed: half the contraction rows
        assert art["blocks"][0]["qkv"].w.shape[0] == cfg.embed_dim // 2


@pytest.mark.parametrize("init_bits", [4.0, 8.0])
def test_int_forward_matches_fake_quant(init_bits):
    cfg, model, params, x = _build(init_bits)
    y_fake = np.asarray(model.apply({"params": params}, x))
    art = export_vit_int4(cfg, params)
    y_int = np.asarray(vit_int4_forward(art, x, cfg))
    np.testing.assert_allclose(y_int, y_fake, rtol=2e-3, atol=2e-3)


def test_scan_blocks_matches_unrolled():
    """lax.scan over stacked block weights (the program-size/compile-time
    variant for deep stacks) is numerically identical to the unrolled
    loop; non-uniform blocks (e.g. GETA subnets) must fall back safely."""
    cfg, model, params, x = _build(4.0)
    art = export_vit_int4(cfg, params)
    a = np.asarray(vit_int4_forward(art, x, cfg, scan_blocks=False))
    b = np.asarray(vit_int4_forward(art, x, cfg, scan_blocks=True))
    np.testing.assert_array_equal(a, b)


def test_nonuniform_bits_mixed_precision_export():
    """GETA yields per-layer bit widths; layers above 4 bits must export as
    int8 while 4-bit layers pack int4 — both in one artifact."""
    cfg, model, params, x = _build(4.0)
    # push one layer to 8 bits
    qkv = params["blocks_0"]["attn"]["qkv"]
    from quantized_vit_tpu.quant import d_for_bits

    qkv["d_quant_wt"] = d_for_bits(
        jnp.array(8.0), qkv["q_m_wt"], qkv["t_quant_wt"]
    ).reshape(1)
    art = export_vit_int4(cfg, params)
    assert art["blocks"][0]["qkv"].fmt == "int8"
    assert art["blocks"][0]["fc1"].fmt == "int4"
    y_fake = np.asarray(model.apply({"params": params}, x))
    y_int = np.asarray(vit_int4_forward(art, x, cfg))
    np.testing.assert_allclose(y_int, y_fake, rtol=2e-3, atol=2e-3)


def test_sharded_serving_matches_unsharded():
    """TP-sharded serving (BASELINE.json config 5's single-host slice of
    the story): the artifact loads with column/row-parallel NamedShardings
    over the 'model' mesh axis + data sharded over 'data'; GSPMD partitions
    the same forward and the logits must match the unsharded run exactly."""
    import tempfile

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from quantized_vit_tpu.artifact import (
        load_vit_int4_artifact,
        save_vit_int4_artifact,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")

    cfg, model, params, x = _build(4.0)
    art = export_vit_int4(cfg, params)
    y_ref = np.asarray(vit_int4_forward(art, x, cfg))

    with tempfile.TemporaryDirectory() as d:
        save_vit_int4_artifact(d, art, cfg)
        mesh = Mesh(np.array(jax.devices()).reshape(2, 4),
                    axis_names=("data", "model"))
        art_sh, cfg_sh = load_vit_int4_artifact(d, mesh=mesh)
        x_sh = jax.device_put(x, NamedSharding(mesh, P("data")))
        with mesh:
            y_sh = np.asarray(
                vit_int4_forward(art_sh, x_sh, cfg_sh))
    np.testing.assert_allclose(y_sh, y_ref, rtol=1e-5, atol=1e-5)


def test_export_requantizes_layers_above_8_bits():
    """Regression: layers trained above int8 range were silently level-
    CLIPPED (wrong logits). Export now requantizes them to a proper 8-bit
    grid (with a warning) — the artifact forward must match the fake-quant
    forward of the model REPROJECTED to 8 bits, not the clipped one."""
    import warnings

    from quantized_vit_tpu.quant.bitwidth import d_for_bits

    cfg, model, params, x = _build(10.0)  # 10-bit: top level 511
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        art = export_vit_int4(cfg, params)
    assert any("requantizing to 8 bits" in str(x.message) for x in w)

    # reproject the fake-quant model itself to 8 bits -> must match
    def reproject(node):
        if not isinstance(node, dict):
            return node
        out = {k: reproject(v) for k, v in node.items()}
        for sfx in ("wt", "act"):
            if f"d_quant_{sfx}" in out:
                t = out.get(f"t_quant_{sfx}")
                out[f"d_quant_{sfx}"] = jnp.broadcast_to(
                    d_for_bits(8.0, out[f"q_m_{sfx}"], t),
                    out[f"d_quant_{sfx}"].shape)
        return out

    p8 = reproject(params)
    y_fake = np.asarray(model.apply({"params": p8}, x))
    y_int = np.asarray(vit_int4_forward(art, x, cfg))
    np.testing.assert_allclose(y_int, y_fake, rtol=2e-4, atol=2e-4)


def test_patches_layout_matches_nhwc():
    """images_layout='patches' (host-patchified input via
    utils.native_prep.patchify_batch) must reproduce the NHWC conv path:
    same integer level math, only the contraction layout differs."""
    from quantized_vit_tpu.utils.native_prep import patchify_batch

    cfg, model, params, x = _build(4.0)
    art = export_vit_int4(cfg, params)
    y_ref = np.asarray(vit_int4_forward(art, x, cfg))
    xp = jnp.asarray(patchify_batch(np.asarray(x), cfg.patch_size))
    y_p = np.asarray(vit_int4_forward(art, xp, cfg, images_layout="patches"))
    np.testing.assert_allclose(y_p, y_ref, rtol=2e-4, atol=2e-4)
