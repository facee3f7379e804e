"""jaxpr tracer + pattern search (the JAX Graph.search / GEParser,
graph/graph.py:664-673, transform/ge.py:9-170) and node-group validation."""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.graph import vit_node_groups
from quantized_vit_tpu.graph.tracer import TracedGraph, validate_node_groups
from quantized_vit_tpu.models import (
    QuantConfig,
    ViTConfig,
    VisionTransformer,
    init_quant_params_tree,
)


@pytest.fixture(scope="module")
def vit_trace():
    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=2,
                    num_heads=4, mlp_ratio=2.0, num_classes=7,
                    quant=QuantConfig(enabled=True))
    m = VisionTransformer(cfg)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    p = init_quant_params_tree(
        flax.core.unfreeze(m.init(jax.random.PRNGKey(0), x)["params"]), 8.0)
    g = TracedGraph.trace(
        lambda pp, xx: m.apply({"params": pp}, xx, deterministic=True),
        p, x, params=p)
    return cfg, p, g


def test_trace_captures_program(vit_trace):
    _, p, g = vit_trace
    ops = set(g.ops())
    # matmuls + softmax internals all visible. (The ViT patch embed
    # traces as a dot since round 5 — QuantConv runs non-overlapping
    # patch convs as the exact space-to-depth GEMM, models/layers.py;
    # conv tracing is covered by test_conv_model_traces_conv below.)
    assert "dot_general" in ops
    assert "exp" in ops
    # params labeled with pytree paths
    used = g.params_used()
    assert "patch_embed/proj/kernel" in used
    assert any(u.startswith("blocks_0/attn/qkv") for u in used)


def test_conv_model_traces_conv():
    """A REAL (overlapping) conv still traces as conv_general_dilated —
    only stride==kernel VALID convs take the GEMM form."""
    from quantized_vit_tpu.models.layers import QuantConv

    m = QuantConv(features=8, kernel_size=(3, 3), strides=(1, 1),
                  config=QuantConfig(enabled=True))
    x = jnp.zeros((1, 8, 8, 3), jnp.float32)
    p = init_quant_params_tree(
        flax.core.unfreeze(m.init(jax.random.PRNGKey(0), x)["params"]), 8.0)
    g = TracedGraph.trace(
        lambda pp, xx: m.apply({"params": pp}, xx), p, x, params=p)
    ops = set(g.ops())
    assert "conv_general_dilated" in ops
    assert len(g.search("conv_general_dilated > *")) >= 1


def test_search_chains(vit_trace):
    _, _, g = vit_trace
    # softmax core: exp feeding a div
    assert len(g.search("exp > div")) > 0
    # dense + bias add chains exist (qkv/proj/fc1/fc2/head)
    assert len(g.search("dot_general > add")) > 0
    # wildcard matches any single op (patch-embed GEMM feeds something)
    assert len(g.search("dot_general > *")) >= 1
    # nonsense chain finds nothing
    assert g.search("exp > conv_general_dilated") == []


def test_search_simple_fn():
    def f(a, b):
        return jnp.tanh(a @ b).sum()

    g = TracedGraph.trace(f, jnp.ones((3, 4)), jnp.ones((4, 5)))
    chains = g.search("dot_general > tanh > reduce_sum")
    assert len(chains) == 1
    assert [n.op for n in chains[0]] == ["dot_general", "tanh", "reduce_sum"]


def test_validate_node_groups_consistent(vit_trace):
    cfg, p, g = vit_trace
    rep = validate_node_groups(g, vit_node_groups(cfg, p), p)
    assert rep["missing"] == []
    assert rep["uncovered"] == []


def test_validate_detects_missing_and_uncovered(vit_trace):
    cfg, p, g = vit_trace
    groups = vit_node_groups(cfg, p)
    # drop the head group -> its kernel becomes uncovered
    groups = [gr for gr in groups if gr.id != "head"]
    rep = validate_node_groups(g, groups, p)
    assert "head/kernel" in rep["uncovered"]
    # declare a bogus path -> reported missing
    import dataclasses
    from quantized_vit_tpu.opt.groups import NodeGroup, ParamEntry, Transform
    groups.append(NodeGroup(id="bogus",
                            entries=[ParamEntry("nope/kernel", Transform.OUT)],
                            num_groups=4))
    rep = validate_node_groups(g, groups, p)
    assert "nope/kernel" in rep["missing"]
