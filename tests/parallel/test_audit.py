"""Collectives audit (parallel/audit.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quantized_vit_tpu.parallel import (
    collective_stats,
    parse_collectives,
    summarize,
)


def test_parse_collectives_from_hlo_text():
    txt = """
  %ar = bf16[8,197,768] all-reduce(bf16[8,197,768] %x), replica_groups={}
  %ag.1 = f32[16,64] all-gather(f32[8,64] %y), dimensions={0}
  %rs = f32[4,64] reduce-scatter(f32[16,64] %z), dimensions={0}
  %other = f32[4] add(f32[4] %a, f32[4] %b)
"""
    ops = parse_collectives(txt)
    kinds = sorted(o.kind for o in ops)
    assert kinds == ["all-gather", "all-reduce", "reduce-scatter"]
    ar = next(o for o in ops if o.kind == "all-reduce")
    assert ar.shape == (8, 197, 768) and ar.bytes == 8 * 197 * 768 * 2


def test_collective_stats_on_sharded_matmul():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    w = jax.device_put(jnp.ones((64, 64), jnp.float32),
                       NamedSharding(mesh, P("model", None)))
    x = jax.device_put(jnp.ones((8, 64), jnp.float32),
                       NamedSharding(mesh, P("data", "model")))

    def fn(x, w):
        return x @ w  # row-sharded contraction => partial sums => all-reduce

    with mesh:
        ops = collective_stats(fn, x, w)
    s = summarize(ops)
    assert any(k in s for k in ("all-reduce", "reduce-scatter")), s


def test_dp_serving_forward_has_zero_collectives():
    """Data-parallel serving communicates nothing: pin that the
    unsharded serving forward's lowering contains no collectives."""
    import functools

    from quantized_vit_tpu.models.vit import ViTConfig
    from quantized_vit_tpu.serve import (random_vit_int4_artifact,
                                         vit_int4_forward)

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=2, num_classes=10)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False)
    x = jnp.zeros((8, 32, 32, 3), jnp.float32)
    ops = collective_stats(
        jax.jit(functools.partial(vit_int4_forward, cfg=cfg,
                                  float_dtype=jnp.bfloat16)), art, x)
    assert summarize(ops) == {}, summarize(ops)
