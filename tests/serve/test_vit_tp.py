"""Tensor-parallel serving forward (serve/vit_tp.py) on the virtual mesh.

The reference has no parallelism at all (single CUDA device, train.py:265);
the TP path is build-mandated (BASELINE.md tensor-sharded serving). These
tests assert (a) bit-parity of the shard_map TP forward against the
single-device forward, (b) that the hand-placed communication is exactly
2 all-gathers + 2 reduce-scatters per block — the GSPMD resharding storm
(all-to-alls, activation all-gathers) the shard_map design exists to kill
must not reappear.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quantized_vit_tpu.models.vit import ViTConfig
from quantized_vit_tpu.parallel import collective_stats, summarize
from quantized_vit_tpu.serve import (prepare_tp_artifact,
                                     random_vit_int4_artifact,
                                     shard_tp_artifact, vit_int4_forward,
                                     vit_int4_forward_tp)
from quantized_vit_tpu.serve.vit_tp import _qkv_head_perm


def _cfg(depth=2, heads=4):
    return ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=depth,
                     num_heads=heads, num_classes=10)


def _mesh(dp, tp):
    devs = np.array(jax.devices()[:dp * tp])
    return Mesh(devs.reshape(dp, tp), axis_names=("data", "model"))


def test_qkv_head_perm_roundtrip():
    heads, hd, tp = 4, 8, 2
    perm = _qkv_head_perm(heads, hd, tp)
    # a contiguous shard of the permuted columns must be the [3, H/tp, hd]
    # layout for that shard's heads
    cols = np.arange(3 * heads * hd)[perm].reshape(tp, 3, heads // tp, hd)
    orig = np.arange(3 * heads * hd).reshape(3, heads, hd)
    for i in range(tp):
        np.testing.assert_array_equal(
            cols[i], orig[:, i * (heads // tp):(i + 1) * (heads // tp)])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_bit_parity(tp):
    cfg = _cfg()
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False)
    imgs = jnp.array(
        np.random.default_rng(0).standard_normal((8, 32, 32, 3)), jnp.float32)
    ref = vit_int4_forward(art, imgs, cfg, float_dtype=jnp.float32)
    mesh = _mesh(8 // tp, tp)
    art_tp = shard_tp_artifact(prepare_tp_artifact(art, cfg, tp), mesh)
    x = jax.device_put(imgs, NamedSharding(mesh, P(("data", "model"))))
    out = vit_int4_forward_tp(art_tp, x, cfg, mesh, float_dtype=jnp.float32,
                              comm_dtype=jnp.float32)
    # exact up to f32 summation order of dequantized partials
    # (sum(acc_i)*s vs sum(acc_i*s)) — tight tolerance, not bitwise
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_bit_parity_packed_int4(tp):
    """fmt='int4' — the DEFAULT export format (export pack_weights=True).

    pack_int4 pairs global rows (k, k+K/2) per byte, so naively sharding a
    row-parallel packed weight over 'model' makes each shard's local
    nibble unpack pair the wrong global rows (ADVICE r3 #1: silently wrong
    logits, max err ~0.6 on this repro before the fix).
    prepare_tp_artifact must re-pack proj/fc2 per shard."""
    cfg = _cfg()
    art = random_vit_int4_artifact(cfg, seed=2, pack_weights=True)
    imgs = jnp.array(
        np.random.default_rng(2).standard_normal((8, 32, 32, 3)), jnp.float32)
    ref = vit_int4_forward(art, imgs, cfg, float_dtype=jnp.float32)
    mesh = _mesh(8 // tp, tp)
    art_tp = shard_tp_artifact(prepare_tp_artifact(art, cfg, tp), mesh)
    x = jax.device_put(imgs, NamedSharding(mesh, P(("data", "model"))))
    out = vit_int4_forward_tp(art_tp, x, cfg, mesh, float_dtype=jnp.float32,
                              comm_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-4)


def test_repack_row_parallel_entry_local_planes():
    """Per-shard repack: shard i's local unpack must reproduce exactly the
    contiguous global rows [i*K/tp, (i+1)*K/tp) in order."""
    from quantized_vit_tpu.quant.packing import pack_int4, unpack_int4
    from quantized_vit_tpu.serve.vit_tp import repack_row_parallel_entry
    from quantized_vit_tpu.serve.vit_int4 import QLayerArtifact

    rng = np.random.default_rng(0)
    k, n, tp = 64, 48, 4
    w = rng.integers(-7, 8, (k, n)).astype(np.int8)
    e = QLayerArtifact(w=pack_int4(jnp.array(w), axis=0),
                       scale=jnp.float32(1.0), bias=None, act={},
                       fmt="int4")
    re = repack_row_parallel_entry(e, tp)
    kp = k // 2
    for i in range(tp):
        local = re.w[i * kp // tp:(i + 1) * kp // tp]
        got = np.asarray(unpack_int4(local, axis=0))
        np.testing.assert_array_equal(got, w[i * k // tp:(i + 1) * k // tp])


def test_tp_forward_bf16_comm_close():
    """Serving config (bf16 residual + bf16 reduce-scatter): the deviation
    from the f32 oracle must be of the same order as the SINGLE-DEVICE bf16
    path's deviation — i.e. the bf16 communication adds no material error
    on top of the bf16 residual stream the serving path already uses. (An
    absolute bound is meaningless here: bf16 noise flips int8 levels on a
    random toy model; the end-task effect is measured by the accuracy
    rehearsal, tests/serve/test_accuracy_e2e.py.)"""
    cfg = _cfg()
    art = random_vit_int4_artifact(cfg, seed=1, pack_weights=False)
    imgs = jnp.array(
        np.random.default_rng(1).standard_normal((8, 32, 32, 3)), jnp.float32)
    mesh = _mesh(4, 2)
    art_tp = shard_tp_artifact(prepare_tp_artifact(art, cfg, 2), mesh)
    x = jax.device_put(imgs, NamedSharding(mesh, P(("data", "model"))))
    exact = np.asarray(vit_int4_forward_tp(
        art_tp, x, cfg, mesh, float_dtype=jnp.float32,
        comm_dtype=jnp.float32))
    served = np.asarray(vit_int4_forward_tp(
        art_tp, x, cfg, mesh, float_dtype=jnp.bfloat16,
        comm_dtype=jnp.bfloat16), np.float32)
    single_bf16 = np.asarray(vit_int4_forward(
        art, imgs, cfg, float_dtype=jnp.bfloat16),
        np.float32)
    dev_tp = np.abs(served - exact).max()
    dev_single = np.abs(single_bf16 - exact).max()
    assert dev_tp <= 1.5 * dev_single + 1e-6, (dev_tp, dev_single)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_collectives_exactly_two_ag_two_rs_per_block(tp):
    """The audited HLO must contain exactly 2 all-gathers and 2
    reduce-scatters per block and NO all-to-all / extra all-reduce — the
    failure mode of the GSPMD path."""
    cfg = _cfg(depth=3)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False)
    imgs = jnp.zeros((8, 32, 32, 3), jnp.float32)
    mesh = _mesh(8 // tp, tp)
    art_tp = shard_tp_artifact(prepare_tp_artifact(art, cfg, tp), mesh)
    x = jax.device_put(imgs, NamedSharding(mesh, P(("data", "model"))))
    fn = jax.jit(functools.partial(
        vit_int4_forward_tp, cfg=cfg, mesh=mesh, float_dtype=jnp.bfloat16,
        comm_dtype=jnp.bfloat16))
    with mesh:
        ops = collective_stats(fn, art_tp, x)
    s = summarize(ops)
    assert s.get("all-gather", {}).get("count", 0) == 2 * cfg.depth, s
    assert s.get("reduce-scatter", {}).get("count", 0) == 2 * cfg.depth, s
    assert "all-to-all" not in s, s
    assert "all-reduce" not in s, s
    # the all-gathers must be int8 (levels gathered BEFORE the matmul)
    ag = [o for o in ops if o.kind == "all-gather"]
    assert all(o.dtype == "s8" for o in ag), [o.dtype for o in ag]


def test_tp_specs_match_artifact_treedef():
    from quantized_vit_tpu.serve import tp_artifact_specs

    cfg = _cfg()
    art = prepare_tp_artifact(
        random_vit_int4_artifact(cfg, seed=0, pack_weights=False), cfg, 2)
    specs = tp_artifact_specs(art)
    # tree.map across (art, specs) requires identical treedefs incl. the
    # QLayerArtifact metadata
    jax.tree.map(lambda a, s: None, art, specs)
