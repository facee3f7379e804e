"""FSDP-style weight-gather INT4 serving: memory-sharded, data-parallel.

- every block weight is sharded over the 'model' axis along its OUTPUT
  columns (``P(None, 'model')``). Column sharding is deliberate: int4
  nibble packing pairs CONTRACTION rows (k, k + K/2) per byte
  (quant/packing.py), so row sharding needs a per-shard re-pack
  (serve/vit_tp.py:repack_row_parallel_entry) while column shards
  all-gather back to the exact original packed array — no re-pack, no
  permutation, works identically for int4 and int8;
- the batch is sharded over ALL devices (``P(('data', 'model'))``) —
  compute is pure data parallel on each device's own images;
- inside shard_map, each block's four weights are all-gathered with a
  ONE-BLOCK LOOKAHEAD: block i+1's gathers are issued before block i's
  compute consumes its results, so XLA's scheduler may overlap the gathers
  (NCCL on GPUs) with the compute;
- after the gather each device runs the EXACT single-device block
  (serve/vit_int4.py:_vit_block) on its own rows.

Use this mode when the model does not fit one card's memory (per-device
weight memory is total/tp); when it does fit, pure DP replicates weights
and communicates nothing. The reference has no parallelism of any kind
(single CUDA device, train.py:265 — SURVEY.md §2.4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..configs import ViTConfig
from .vit_int4 import (QLayerArtifact, _embed_tokens, _head, _round_up,
                       _vit_block)

_SHARDED = ("qkv", "proj", "fc1", "fc2")


def prepare_fsdp_artifact(art: Dict[str, Any], cfg: ViTConfig, tp: int):
    """Validate a serving artifact for tp-way weight sharding.

    Column sharding needs every block weight's output width divisible by
    tp; ViT-B/L/H widths (3D, D, 4D) all divide any power-of-two tp. The
    artifact itself is UNCHANGED (no permutation, no re-pack — see module
    docstring); this exists so misuse fails loudly at prep time, and for
    symmetry with :func:`~.vit_tp.prepare_tp_artifact`."""
    for i, b in enumerate(art["blocks"]):
        for k in _SHARDED:
            n = b[k].w.shape[1]
            if n % tp:
                raise ValueError(
                    f"block {i} {k}: output width {n} not divisible by "
                    f"tp={tp} — FSDP column sharding needs n % tp == 0")
    return art


def _qentry_fsdp_specs(e: QLayerArtifact) -> QLayerArtifact:
    """Spec pytree for one sharded entry: w column-sharded over 'model',
    scale/bias/act replicated (tiny — the memory win is the weights)."""
    return dataclasses.replace(
        e, w=P(None, "model"), scale=P(),
        bias=None if e.bias is None else P(),
        act={k: P() for k in e.act},
    )


def fsdp_artifact_specs(art: Dict[str, Any]):
    """PartitionSpec pytree: block weights column-sharded over 'model',
    everything else (embeddings, LN, head — <3% of bytes) replicated."""
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    out = {
        "patch_embed": rep(art["patch_embed"]),
        "cls_token": P(),
        "pos_embed": P(),
        "norm": rep(art["norm"]),
        "blocks": [
            {
                "norm1": rep(b["norm1"]),
                "norm2": rep(b["norm2"]),
                **{k: _qentry_fsdp_specs(b[k]) for k in _SHARDED},
            }
            for b in art["blocks"]
        ],
    }
    if "pre_logits" in art:
        out["pre_logits"] = rep(art["pre_logits"])
    if "head" in art:
        out["head"] = rep(art["head"])
    return out


def shard_fsdp_artifact(art: Dict[str, Any], mesh: Mesh):
    """Place an artifact onto the mesh per fsdp_artifact_specs (per-device
    weight bytes drop to total/tp)."""
    specs = fsdp_artifact_specs(art)
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), art, specs)


def _gather_entry(e: QLayerArtifact) -> QLayerArtifact:
    """All-gather one weight shard back to the full packed array (tiled
    along the column axis — shard order == original column order)."""
    return dataclasses.replace(
        e, w=jax.lax.all_gather(e.w, "model", axis=1, tiled=True))


def _gather_block(blk):
    return {**blk, **{k: _gather_entry(blk[k]) for k in _SHARDED}}


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "mesh", "float_dtype", "images_layout",
                     "int_attention", "input_scale"),
)
def vit_int4_forward_fsdp(art, images, cfg: ViTConfig, mesh: Mesh,
                          float_dtype=jnp.bfloat16,
                          images_layout: str = "nhwc",
                          int_attention: bool = False,
                          input_scale: float | None = None):
    """Weight-gather (FSDP-style) quantized ViT forward (module docstring).

    art: artifact validated by :func:`prepare_fsdp_artifact` and placed by
    :func:`shard_fsdp_artifact`. images: [B, H, W, 3] f32 (or
    host-patchified with images_layout='patches'; integer pixels with
    ``input_scale``); B must divide the device count. Returns
    [B, classes] logits sharded over the batch.

    Numerics: the gathered weights are bit-identical to the originals and
    each device runs the single-device block on its own rows, so the
    result equals :func:`~.vit_int4.vit_int4_forward` (exactly on the CPU;
    on a GPU the library may pick other dot algorithms for the smaller
    per-device batch)."""
    if "model" not in mesh.axis_names or "data" not in mesh.axis_names:
        raise ValueError("mesh must carry ('data', 'model') axes")
    n_dev = mesh.shape["data"] * mesh.shape["model"]
    b = images.shape[0]
    if b % n_dev:
        raise ValueError(f"batch {b} not divisible by device count {n_dev}")

    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, 16)
    hd = cfg.embed_dim // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5

    def body(art, images_loc):
        b_loc = images_loc.shape[0]
        if input_scale is not None:
            images_loc = (images_loc.astype(jnp.float32)
                          * jnp.float32(input_scale))
        x2d, _, dim = _embed_tokens(art, images_loc, cfg, float_dtype,
                                    images_layout, n_align=16)

        blocks = art["blocks"]
        # one-block lookahead: issue block i+1's weight gathers before
        # block i's compute consumes its own — the gathers have no data
        # dependence on the compute, so the scheduler can overlap them
        gathered = _gather_block(blocks[0])
        for i in range(len(blocks)):
            cur = gathered
            if i + 1 < len(blocks):
                gathered = _gather_block(blocks[i + 1])
            x2d = _vit_block(x2d, cur, b=b_loc, n_pad=n_pad,
                             n_real=n_real, dim=dim, hd=hd,
                             sm_scale=sm_scale, float_dtype=float_dtype,
                             int_attention=int_attention)

        return _head(x2d.reshape(b_loc, n_pad, dim)[:, n_real - 1], art)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(fsdp_artifact_specs(art), P(("data", "model"))),
        out_specs=P(("data", "model")),
        check_vma=False,
    )
    return fn(art, images)
