"""Explicit tensor-parallel INT4 ViT serving with hand-placed collectives.

The GSPMD-sharded path (parallel/partition.py rules over
serve/vit_int4.py) lets the partitioner infer communication, and the
collectives audit (parallel/audit.py) showed it inferring badly: the
fused-qkv column shard splits the [q|k|v] layout mid-tensor, so GSPMD
reshards around every attention (72 all-to-alls + 12 full activation
all-gathers per step at TP=2). This module places every collective by hand
via ``jax.shard_map`` — Megatron-TP with sequence(-sharded) LayerNorm
(Megatron-SP); on GPUs XLA hands the collectives to NCCL:

- the residual stream stays SEQUENCE-SHARDED over the 'model' axis: each
  device owns the rows of its b_loc whole images (LayerNorm, quantization
  and residual adds run tp-way parallel instead of replicated);
- qkv / fc1 are column-parallel with the qkv columns PRE-PERMUTED to
  head-major order (:func:`permute_qkv_entry`) so a contiguous shard is a
  valid [3, H/tp, hd] block — no resharding, attention is fully local;
- the all-gather into each column matmul carries **int8 levels** (the
  LayerNorm+quantize prologue runs BEFORE the gather), halving gather
  bytes vs bf16 activations;
- proj / fc2 are row-parallel; partial products are combined with a
  **reduce-scatter** (psum_scatter) back to sequence shards — the
  all-reduce of plain Megatron never materializes;
- per block the step communicates exactly 2 all-gathers (int8 [M, D]) and
  2 reduce-scatters ([M, D] in ``comm_dtype``), nothing else.

comm_dtype: f32 reduce-scatter reproduces the single-device float
accumulation order closely (parity mode); bf16 is the serving default
(the residual stream is bf16 anyway — one extra rounding of the partial
sums, bounded by 1 bf16 ulp of the partials); int8 would halve RS bytes
but changes numerics materially and is not offered.

The reference has no parallelism of any kind (single CUDA device,
train.py:265 — SURVEY.md §2.4); this is the build-mandated tensor-sharded
serving path (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..configs import ViTConfig
from ..ops import attention_qkv_xla
from ..ops.fused import _layernorm_f32, _quantize_f32
from .vit_int4 import (QLayerArtifact, _embed_tokens, _head, _qmatmul,
                       _round_up)


# ---------------------------------------------------------------------------
# artifact preparation: head-major qkv columns + shard placement
# ---------------------------------------------------------------------------


def _qkv_head_perm(heads: int, head_dim: int, tp: int) -> np.ndarray:
    """Column permutation [3*H*hd] -> head-major-by-shard order.

    Global qkv layout is [3, H, hd] (vit_model.py:139 fused qkv). Shard i
    of the permuted matrix must itself be a valid [3, H/tp, hd] block for
    heads [i*H/tp, (i+1)*H/tp), so a contiguous 'model'-axis split gives
    every device complete heads with the layout attention_qkv expects."""
    if heads % tp:
        raise ValueError(f"heads={heads} not divisible by tp={tp}")
    h_loc = heads // tp
    cols = np.arange(3 * heads * head_dim).reshape(3, heads, head_dim)
    # target [tp, 3, h_loc, hd]: shard-major, then the local [3, h_loc, hd]
    perm = np.transpose(
        cols.reshape(3, tp, h_loc, head_dim), (1, 0, 2, 3)
    ).reshape(-1)
    return perm


def permute_qkv_entry(e: QLayerArtifact, heads: int, head_dim: int,
                      tp: int) -> QLayerArtifact:
    """Reorder a fused-qkv artifact entry's output columns head-major (see
    :func:`_qkv_head_perm`). Weight packing is along K (axis 0), so the
    column gather applies identically to packed int4 and int8 storage."""
    perm = _qkv_head_perm(heads, head_dim, tp)
    return dataclasses.replace(
        e,
        w=jnp.take(e.w, perm, axis=1),
        scale=(jnp.take(e.scale, perm) if getattr(e.scale, "ndim", 0) == 1
               else e.scale),
        bias=None if e.bias is None else jnp.take(e.bias, perm),
    )


def repack_row_parallel_entry(e: QLayerArtifact, tp: int) -> QLayerArtifact:
    """Re-pack a ROW-parallel int4 entry so each 'model'-axis shard's local
    nibble planes pair the right global rows.

    pack_int4 pairs global rows (k, k + K/2) per byte (quant/packing.py),
    so naively sharding the packed [K/2, N] array over tp gives shard i
    packed rows whose lo/hi nibbles decode to global rows
    [i*K/(2tp), ...) and [K/2 + i*K/(2tp), ...) — NOT the contiguous
    [i*K/tp, (i+1)*K/tp) block of contraction rows shard i's activations
    actually cover (ADVICE r3 #1: silently wrong logits for fmt='int4').
    Fix: unpack, split K into tp contiguous chunks, pack WITHIN each chunk,
    concatenate — shard i's local unpack then reproduces exactly its own
    rows in order. int8 entries shard correctly as-is and pass through."""
    if tp == 1 or e.fmt != "int4":
        return e
    from ..quant.packing import pack_int4, unpack_int4

    w_full = unpack_int4(e.w, axis=0)
    k = w_full.shape[0]
    if k % (2 * tp):
        raise ValueError(
            f"row-parallel int4 repack needs K divisible by 2*tp; "
            f"got K={k}, tp={tp}")
    w_new = jnp.concatenate(
        [pack_int4(c, axis=0) for c in jnp.split(w_full, tp, axis=0)],
        axis=0)
    return dataclasses.replace(e, w=w_new)


def prepare_tp_artifact(art: Dict[str, Any], cfg: ViTConfig, tp: int):
    """Single-device serving artifact -> TP-ready artifact: qkv columns
    permuted head-major for this tp, and the ROW-parallel entries
    (proj/fc2) re-packed per shard when fmt == 'int4'
    (:func:`repack_row_parallel_entry`). Everything else is unchanged; the
    sharding itself is applied by :func:`tp_artifact_specs` +
    ``jax.device_put`` or by shard_map's in_specs."""
    hd = cfg.embed_dim // cfg.num_heads
    out = dict(art)
    out["blocks"] = []
    for b in art["blocks"]:
        heads = b["qkv"].w.shape[1] // (3 * hd)
        nb = dict(b)
        nb["qkv"] = permute_qkv_entry(b["qkv"], heads, hd, tp)
        nb["proj"] = repack_row_parallel_entry(b["proj"], tp)
        nb["fc2"] = repack_row_parallel_entry(b["fc2"], tp)
        out["blocks"].append(nb)
    return out


def _qentry_specs(e: QLayerArtifact, kind: str) -> QLayerArtifact:
    """Spec pytree for one QLayerArtifact ('col'/'row'/'rep'), preserving
    the entry's metadata (fmt/act_pow/top are part of the treedef)."""
    w_spec = {"col": P(None, "model"), "row": P("model", None),
              "rep": P()}[kind]
    bias_spec = P("model") if kind == "col" else P()
    return dataclasses.replace(
        e, w=w_spec, scale=P(),
        bias=None if e.bias is None else bias_spec,
        act={k: P() for k in e.act},
    )


def tp_artifact_specs(art: Dict[str, Any]):
    """Pytree of PartitionSpec matching a (TP-prepared) serving artifact:
    qkv/fc1 column-sharded, proj/fc2 row-sharded, the rest replicated."""
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    out = {
        "patch_embed": _qentry_specs(art["patch_embed"], "rep"),
        "cls_token": P(),
        "pos_embed": P(),
        "norm": rep(art["norm"]),
        "blocks": [
            {
                "norm1": rep(b["norm1"]),
                "qkv": _qentry_specs(b["qkv"], "col"),
                "proj": _qentry_specs(b["proj"], "row"),
                "norm2": rep(b["norm2"]),
                "fc1": _qentry_specs(b["fc1"], "col"),
                "fc2": _qentry_specs(b["fc2"], "row"),
            }
            for b in art["blocks"]
        ],
    }
    if "pre_logits" in art:
        out["pre_logits"] = rep(art["pre_logits"])
    if "head" in art:
        out["head"] = _qentry_specs(art["head"], "rep")
    return out


def shard_tp_artifact(art: Dict[str, Any], mesh: Mesh):
    """Place a TP-prepared artifact onto the mesh per tp_artifact_specs."""
    specs = tp_artifact_specs(art)
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), art, specs)


# ---------------------------------------------------------------------------
# the shard_map forward
# ---------------------------------------------------------------------------


def _ln_quant(x, ln, entry: QLayerArtifact, ln_eps: float = 1e-6):
    """LayerNorm + LSFQ quantize to a layer's int8 input levels — the same
    constant-folded f32 math as the ln_quant prologue in ops/fused.py
    (1/d folded into gamma/beta when t == 1), run standalone so the result
    can be all-gathered as int8 BEFORE the column matmul."""
    d = jnp.asarray(entry.act["d"], jnp.float32)
    t = jnp.asarray(entry.act["t"], jnp.float32)
    gamma = jnp.asarray(ln["scale"], jnp.float32)
    beta = jnp.asarray(ln["bias"], jnp.float32)
    folded = not entry.act_pow
    if folded:
        inv_d = 1.0 / d
        gamma = gamma * inv_d
        beta = beta * inv_d
    y = _layernorm_f32(x, gamma, beta, ln_eps)
    return _quantize_f32(y, d, t, jnp.asarray(entry.top, jnp.int32),
                         entry.act_pow, folded=folded)


def tp_block(x2d, blk, *, b_grp: int, n_pad: int, n_real: int, hd: int,
             sm_scale: float, float_dtype, comm_dtype):
    """One transformer block inside the 'model'-axis shard_map of
    :func:`vit_int4_forward_tp`: x2d is this device's [b_loc * n_pad, D]
    residual rows, ``b_grp`` = b_loc * tp the images of the model group.
    Communicates 2 int8 all-gathers and 2 ``comm_dtype`` reduce-scatters."""
    proj_e = blk["proj"]
    fc2_e = blk["fc2"]
    heads_loc = blk["qkv"].w.shape[1] // (3 * hd)

    # -- attention: int8 AG -> column qkv -> local heads -> row RS
    lv = _ln_quant(x2d, blk["norm1"], blk["qkv"])
    lv_all = jax.lax.all_gather(lv, "model", axis=0, tiled=True)
    qkv = _qmatmul(lv_all, blk["qkv"], float_dtype,
                   prologue=None, epilogue=None)
    alv = attention_qkv_xla(
        qkv.reshape(b_grp, n_pad, 3 * heads_loc * hd),
        heads=heads_loc, sm_scale=sm_scale, n_valid=n_real,
        out_d=proj_e.act["d"], out_t=proj_e.act["t"],
        out_top=proj_e.top, out_pow=proj_e.act_pow,
    )
    part = _qmatmul(
        alv.reshape(b_grp * n_pad, heads_loc * hd),
        dataclasses.replace(proj_e, bias=None), jnp.float32,
        prologue=None, epilogue=None,
    ).astype(comm_dtype)
    part = jax.lax.psum_scatter(part, "model", scatter_dimension=0,
                                tiled=True)
    x2d = (x2d.astype(jnp.float32) + part.astype(jnp.float32)
           + proj_e.bias).astype(float_dtype)

    # -- MLP: int8 AG -> column fc1 (+GELU+quant) -> row fc2 RS
    lv2 = _ln_quant(x2d, blk["norm2"], blk["fc1"])
    lv2_all = jax.lax.all_gather(lv2, "model", axis=0, tiled=True)
    hlv = _qmatmul(
        lv2_all, blk["fc1"], float_dtype,
        prologue=None, epilogue="gelu_quant",
        out_d=fc2_e.act["d"], out_t=fc2_e.act["t"],
        out_top=fc2_e.top, out_pow=fc2_e.act_pow,
    )
    part2 = _qmatmul(
        hlv, dataclasses.replace(fc2_e, bias=None), jnp.float32,
        prologue=None, epilogue=None,
    ).astype(comm_dtype)
    part2 = jax.lax.psum_scatter(part2, "model", scatter_dimension=0,
                                 tiled=True)
    return (x2d.astype(jnp.float32) + part2.astype(jnp.float32)
            + fc2_e.bias).astype(float_dtype)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "mesh", "float_dtype", "comm_dtype",
                     "images_layout", "input_scale"),
)
def vit_int4_forward_tp(art, images, cfg: ViTConfig, mesh: Mesh,
                        float_dtype=jnp.bfloat16,
                        comm_dtype=jnp.bfloat16,
                        images_layout: str = "nhwc",
                        input_scale: float | None = None):
    """Tensor-parallel quantized ViT forward (see module docstring).

    art: TP-prepared artifact (:func:`prepare_tp_artifact`). images:
    [B, H, W, 3] f32 (or host-patchified with images_layout='patches';
    integer pixels with ``input_scale``, as in
    :func:`~.vit_int4.vit_int4_forward`).
    mesh: ('data', 'model') Mesh; B must divide dp*tp. Returns [B, classes]
    logits sharded over the batch.

    Per-device work inside shard_map: embed OWN images -> sequence-sharded
    residual rows; per block
      lv   = quant(LN1(x_loc))               local     int8 [M_loc, D]
      lvA  = all_gather(lv, 'model')         COLLECTIVE int8 [M_grp, D]
      qkv  = lvA @ Wqkv_loc                  local     [M_grp, 3*H_loc*hd]
      alv  = attention(qkv)  (local heads)   local     int8 [M_grp, H_loc*hd]
      part = alv @ Wproj_loc                 local     f32  [M_grp, D]
      x   += reduce_scatter(part) + bias     COLLECTIVE [M_loc, D]
      ... same pair for fc1(+GELU+quant) / fc2 ...
    and the head runs on each device's own cls rows — no other
    communication exists in the step.
    """
    if "model" not in mesh.axis_names or "data" not in mesh.axis_names:
        raise ValueError("mesh must carry ('data', 'model') axes")
    tp = mesh.shape["model"]
    dp = mesh.shape["data"]
    b = images.shape[0]
    if b % (dp * tp):
        raise ValueError(f"batch {b} not divisible by dp*tp={dp * tp}")

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
        for blk in art["blocks"]:
            x2d = tp_block(x2d, blk, b_grp=b_loc * tp, n_pad=n_pad,
                           n_real=n_real, hd=hd, sm_scale=sm_scale,
                           float_dtype=float_dtype, comm_dtype=comm_dtype)

        # head on OWN images' cls rows (sequence shards hold whole images)
        return _head(x2d.reshape(b_loc, n_pad, dim)[:, n_real - 1], art)

    art_specs = tp_artifact_specs(art)
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(art_specs, P(("data", "model"))),
        out_specs=P(("data", "model")),
        check_vma=False,
    )
    return fn(art, images)
