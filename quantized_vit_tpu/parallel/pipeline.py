"""Pipeline parallelism over transformer blocks (GPipe schedule).

The reference has no parallelism of any kind (SURVEY.md §2.4: training is
single-device, train.py:265); pipeline parallelism is one of the
build-mandated strategies. Design: the 12 homogeneous ViT blocks
(vit_model.py:202-208) are stacked along a leading stage axis that is
sharded over a ``pipe`` mesh axis with ``shard_map``; activations flow
between stages with ``lax.ppermute``. The schedule is GPipe: with
S stages and M microbatches the loop runs M + S - 1 steps, stage s
processing microbatch (t - s) at step t (fill/drain bubbles run on zeros).

Patch embedding and the head are kept outside the pipeline (replicated,
negligible compute next to the 12 blocks); this composes with the DPxTP
sharding in parallel/partition.py by using a 3-axis mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def stack_block_params(params: dict, depth: int, prefix: str = "blocks_"):
    """Stack per-block params ``blocks_0..blocks_{depth-1}`` along a new
    leading axis (the stage-shardable layout). Blocks must be homogeneous
    (uniform heads/hidden — true for the unpruned ViT family)."""
    blocks = [params[f"{prefix}{i}"] for i in range(depth)]
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *blocks)


def unstack_block_params(stacked, depth: int, prefix: str = "blocks_"):
    """Inverse of :func:`stack_block_params`."""
    return {
        f"{prefix}{i}": jax.tree.map(lambda x: x[i], stacked)
        for i in range(depth)
    }


def gpipe_blocks(
    stacked_params,
    x_microbatches: jax.Array,
    block_apply: Callable[[Any, jax.Array], jax.Array],
    *,
    mesh: Mesh,
    axis: str = "pipe",
):
    """Run stacked blocks as a GPipe pipeline over ``mesh[axis]``.

    stacked_params: pytree with leading dim ``depth`` (must be divisible by
      the number of stages); sharded dim 0 over ``axis``.
    x_microbatches: [n_micro, mb, ...] activations (replicated).
    block_apply(block_params, x) -> x applies ONE block.

    Returns [n_micro, mb, ...] outputs after all ``depth`` blocks, fully
    replicated (broadcast from the last stage).
    """
    n_stages = mesh.shape[axis]
    depth = jax.tree.leaves(stacked_params)[0].shape[0]
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by stages {n_stages}")
    n_micro = x_microbatches.shape[0]

    def stage_fn(local_params, x_all):
        idx = jax.lax.axis_index(axis)
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def chain(x):
            def body(h, bp):
                return block_apply(bp, h), None

            h, _ = jax.lax.scan(body, x, local_params)
            return h

        buf = jnp.zeros_like(x_all[0])
        ys = jnp.zeros_like(x_all)
        for t in range(n_micro + n_stages - 1):
            feed = x_all[t] if t < n_micro else jnp.zeros_like(buf)
            inp = jnp.where(idx == 0, feed, buf)
            out = chain(inp)
            j = t - (n_stages - 1)
            if j >= 0:
                ys = ys.at[j].set(jnp.where(idx == n_stages - 1, out, ys[j]))
            if t != n_micro + n_stages - 2:
                buf = jax.lax.ppermute(out, axis, perm)
        # broadcast the last stage's outputs to every device
        return jax.lax.psum(
            jnp.where(idx == n_stages - 1, ys, jnp.zeros_like(ys)), axis)

    spec_params = jax.tree.map(lambda _: P(axis), stacked_params)
    other_axes = [a for a in mesh.axis_names if a != axis]
    # the manual result is not replication-typed (psum-of-where broadcast)
    return jax.shard_map(
        stage_fn, mesh=mesh,
        in_specs=(spec_params, P()),
        out_specs=P(),
        check_vma=False,
    )(stacked_params, x_microbatches)


def vit_pipeline_forward(
    model,
    params: dict,
    images: jax.Array,
    *,
    mesh: Mesh,
    axis: str = "pipe",
    n_microbatches: int = 2,
) -> jax.Array:
    """Full ViT forward with the block stack pipelined over ``mesh[axis]``.

    Embedding (patch conv + cls + pos) and the final norm/head run
    replicated outside the pipeline; the batch is split into
    ``n_microbatches`` along dim 0 (batch must divide evenly).
    """
    from flax.core import freeze

    from ..models.vit import Block

    cfg = model.cfg
    b = images.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches}")
    if cfg.heads_per_block is not None or cfg.hidden_per_block is not None:
        raise ValueError("pipeline requires homogeneous blocks")

    # --- replicated prologue: embed + cls + pos (vit_model.py:290-305) ---
    p = cfg.patch_size
    g = cfg.img_size // p
    embed = model.apply  # reuse the model's own patch embed via submodule
    from ..models.vit import PatchEmbed

    pe = PatchEmbed(cfg)
    x = pe.apply({"params": params["patch_embed"]}, images)
    cls = jnp.broadcast_to(params["cls_token"], (b, 1, cfg.embed_dim))
    x = jnp.concatenate([cls, x], axis=1) + params["pos_embed"]

    # --- pipelined blocks ---
    stacked = stack_block_params(params, cfg.depth)
    block = Block(cfg, drop_path_rate=0.0)

    def block_apply(bp, h):
        return block.apply({"params": bp}, h, True)

    mb = b // n_microbatches
    x_mb = x.reshape(n_microbatches, mb, *x.shape[1:])
    y_mb = gpipe_blocks(stacked, x_mb, block_apply, mesh=mesh, axis=axis)
    x = y_mb.reshape(b, *x.shape[1:])

    # --- replicated epilogue: norm + (pre_logits) + head ---
    import flax.linen as nn

    x = nn.LayerNorm(epsilon=1e-6).apply({"params": params["norm"]}, x)
    x = x[:, 0]
    if cfg.representation_size is not None:
        x = jnp.tanh(x @ params["pre_logits"]["kernel"]
                     + params["pre_logits"]["bias"])
    if cfg.num_classes > 0:
        from ..models.layers import QuantDense

        head = QuantDense(features=cfg.num_classes, config=cfg.quant)
        x = head.apply({"params": params["head"]}, x)
    return x
