"""FSDP weight-gather serving forward (serve/vit_fsdp.py) on the virtual
mesh.

Asserts (a) exact parity against the single-device forward for BOTH weight
formats (column sharding must not disturb int4 packing), (b) the
hand-placed communication is exactly 4 weight all-gathers per block — int8
wire dtype, no reduce-scatter / all-reduce / all-to-all (compute is pure
data parallel), (c) per-device weight bytes actually drop to total/tp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quantized_vit_tpu.models.vit import ViTConfig
from quantized_vit_tpu.parallel import collective_stats, summarize
from quantized_vit_tpu.serve import (prepare_fsdp_artifact,
                                     random_vit_int4_artifact,
                                     shard_fsdp_artifact, vit_int4_forward,
                                     vit_int4_forward_fsdp)


def _cfg(depth=2, heads=4):
    return ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=depth,
                     num_heads=heads, num_classes=10)


def _mesh(dp, tp):
    devs = np.array(jax.devices()[:dp * tp])
    return Mesh(devs.reshape(dp, tp), axis_names=("data", "model"))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_fsdp_forward_exact_parity(tp, packed):
    """Gathered weights are bit-identical to the originals and each device
    runs the single-device pipeline on its own rows -> parity is EXACT
    (same f32 summation order), unlike TP's partial-sum tolerance."""
    cfg = _cfg()
    art = random_vit_int4_artifact(cfg, seed=3, pack_weights=packed)
    imgs = jnp.array(
        np.random.default_rng(3).standard_normal((8, 32, 32, 3)),
        jnp.float32)
    ref = vit_int4_forward(art, imgs, cfg, float_dtype=jnp.float32)
    mesh = _mesh(8 // (2 * tp) if tp == 2 else 1, tp)
    art_f = shard_fsdp_artifact(prepare_fsdp_artifact(art, cfg, tp), mesh)
    x = jax.device_put(imgs, NamedSharding(mesh, P(("data", "model"))))
    out = vit_int4_forward_fsdp(art_f, x, cfg, mesh, float_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_fsdp_collectives_exactly_four_weight_gathers_per_block():
    """Per block: exactly 4 all-gathers (qkv/proj/fc1/fc2 weight shards,
    int8 on the wire) and NOTHING else — no reduce-scatter/all-reduce
    (pure-DP compute) and no all-to-all (the GSPMD failure mode)."""
    cfg = _cfg(depth=3)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True)
    imgs = jnp.zeros((8, 32, 32, 3), jnp.float32)
    mesh = _mesh(2, 4)
    art_f = shard_fsdp_artifact(prepare_fsdp_artifact(art, cfg, 4), mesh)
    x = jax.device_put(imgs, NamedSharding(mesh, P(("data", "model"))))
    fn = jax.jit(functools.partial(
        vit_int4_forward_fsdp, cfg=cfg, mesh=mesh, float_dtype=jnp.bfloat16))
    with mesh:
        ops = collective_stats(fn, art_f, x)
    s = summarize(ops)
    assert s.get("all-gather", {}).get("count", 0) == 4 * cfg.depth, s
    assert "reduce-scatter" not in s, s
    assert "all-reduce" not in s, s
    assert "all-to-all" not in s, s
    ag = [o for o in ops if o.kind == "all-gather"]
    assert all(o.dtype == "s8" for o in ag), [o.dtype for o in ag]


def test_fsdp_per_device_weight_bytes_shrink():
    """The point of the mode: block weight bytes per device == total/tp."""
    cfg = _cfg()
    tp = 4
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True)
    mesh = _mesh(1, tp)
    art_f = shard_fsdp_artifact(prepare_fsdp_artifact(art, cfg, tp), mesh)
    for b in art_f["blocks"]:
        for k in ("qkv", "proj", "fc1", "fc2"):
            w = b[k].w
            shard_shapes = {s.data.shape
                            for s in w.addressable_shards}
            assert shard_shapes == {(w.shape[0], w.shape[1] // tp)}, (
                k, shard_shapes, w.shape)


def test_fsdp_prep_rejects_nondividing_width():
    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=60, depth=1,
                    num_heads=4, num_classes=10)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False)
    with pytest.raises(ValueError, match="not divisible"):
        prepare_fsdp_artifact(art, cfg, 8)
