"""Node-group metadata and tensor<->group-space transforms (flax layouts).

JAX counterpart of the reference's transform language
(only_train_once/transform/tensor_transform.py:3-105) and param-group
payloads (only_train_once/graph/node_group.py:146-176). The reference drags
a traced ONNX graph around to know how each tensor maps onto its pruning
groups; here every :class:`NodeGroup` carries that mapping declaratively as
(param path, Transform) entries over the flax params pytree.

Layout note: torch Linear weights are [out, in] and the reference's BASIC
transform is ``view(num_groups, -1)`` over the out axis
(tensor_transform.py:75-76). Flax kernels are [in..., out], so the same
semantic group-major view is OUT (= moveaxis(-1, 0)). The torch TRANSPOSE
transform (group by dim 1) correspondingly becomes IN here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class Transform(enum.Enum):
    """How a param tensor maps onto its node group's pruning groups."""

    NO_PRUNE = "no_prune"      # quant scalars d/q_m/t — never touched
    OUT = "out"                # group by last (output/features) axis
    IN = "in"                  # group by first (input) axis
    ACCESSORY = "accessory"    # 1-D per-channel params (bias, LN/BN scale)
    QKV_HEADS = "qkv_heads"    # fused qkv [in, 3*H*hd] grouped by head
                               # (operator.py:1188-1205 chained transform)
    HEADS = "heads"            # [in, H*hd] grouped by head (proj input side
                               # uses index expansion, not this)


@dataclasses.dataclass(frozen=True)
class ParamEntry:
    """One parameter's membership in a node group.

    ``path`` addresses the leaf in the params pytree ('/'-joined keys).
    """

    path: str
    transform: Transform


@dataclasses.dataclass
class NodeGroup:
    """A set of parameters sharing one structured-pruning decision.

    Mirrors node_group.py:127-176: ``num_groups`` is the pruning granularity
    (out channels, or heads for attention), entries list every tensor whose
    rows live in this group's space.
    """

    id: str
    entries: List[ParamEntry]
    num_groups: int
    num_heads: int = 1           # for QKV_HEADS: H (head_dim = out/(3*H))
    is_prunable: bool = True
    is_auxiliary: bool = False
    # (auxiliary group id, row offset) links — concat-fed groups
    # (node_group.py:241-254). Unused by ViT/UltraNet but kept for parity.
    auxiliary_ngs: Tuple[Tuple[str, int], ...] = ()


# ---------------------------------------------------------------------------
# Pytree path access
# ---------------------------------------------------------------------------


def get_path(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def set_path(tree, path: str, value):
    """Functional set — returns a new tree with ``path`` replaced."""
    keys = path.split("/")

    def rec(node, i):
        out = dict(node)
        if i == len(keys) - 1:
            out[keys[i]] = value
        else:
            out[keys[i]] = rec(node[keys[i]], i + 1)
        return out

    return rec(tree, 0)


def has_path(tree, path: str) -> bool:
    node = tree
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


# ---------------------------------------------------------------------------
# Group-space views
# ---------------------------------------------------------------------------


def group_matrix(param: jax.Array, transform: Transform, num_groups: int,
                 num_heads: int = 1) -> Optional[jax.Array]:
    """View ``param`` as [num_groups, -1] in group-major order, or None for
    NO_PRUNE (the reference skips those — tensor_transform.py:53-55)."""
    if transform == Transform.NO_PRUNE:
        return None
    if transform == Transform.ACCESSORY:
        return param.reshape(num_groups, -1)
    if transform == Transform.OUT:
        return jnp.moveaxis(param, -1, 0).reshape(num_groups, -1)
    if transform == Transform.IN:
        return param.reshape(num_groups, -1)
    if transform == Transform.QKV_HEADS:
        h = num_heads
        if param.ndim == 1:  # bias [3*H*hd]
            hd = param.shape[0] // (3 * h)
            return (param.reshape(3, h, hd).transpose(1, 0, 2)
                    .reshape(h, -1))
        in_dim = param.shape[0]
        hd = param.shape[-1] // (3 * h)
        # [in, 3, H, hd] -> [H, 3, hd, in] -> [H, 3*hd*in]
        return (param.reshape(in_dim, 3, h, hd).transpose(2, 1, 3, 0)
                .reshape(h, -1))
    if transform == Transform.HEADS:
        h = num_heads
        if param.ndim == 1:
            return param.reshape(h, -1)
        in_dim = param.shape[0]
        return (param.reshape(in_dim, h, -1).transpose(1, 2, 0)
                .reshape(h, -1))
    raise ValueError(f"unhandled transform {transform}")


def group_mask_for_param(mask: jax.Array, transform: Transform,
                         param_shape: Sequence[int],
                         num_heads: int = 1) -> Optional[jax.Array]:
    """Expand a per-group {0,1} mask into a mask broadcastable to ``param``.

    Used for masked row updates (decay/zeroing) — the jit-safe equivalent of
    the reference's fancy-indexed ``p.data[idxes] -= ...``
    (geta.py:982-1000, base_hybrid_sparse_optimizer.py:194-219).
    """
    ndim = len(param_shape)
    if transform == Transform.NO_PRUNE:
        return None
    if transform == Transform.ACCESSORY:
        reps = int(np.prod(param_shape)) // mask.shape[0]
        return jnp.repeat(mask, reps).reshape(param_shape)
    if transform == Transform.OUT:
        # num_groups may be coarser than the axis (GroupNorm-style spread,
        # the reference's MULTIHEAD_NUMHEAD_SPREAD overwrite in
        # pruning_dependency.py:426-538): each group covers a contiguous run
        # of axis_size/num_groups channels.
        run = param_shape[-1] // mask.shape[0]
        m = jnp.repeat(mask, run) if run > 1 else mask
        return m.reshape((1,) * (ndim - 1) + (param_shape[-1],))
    if transform == Transform.IN:
        run = param_shape[0] // mask.shape[0]
        m = jnp.repeat(mask, run) if run > 1 else mask
        return m.reshape((param_shape[0],) + (1,) * (ndim - 1))
    if transform == Transform.QKV_HEADS:
        h = mask.shape[0]
        out = param_shape[-1]
        hd = out // (3 * h)
        m = jnp.tile(jnp.repeat(mask, hd), 3)  # [3*H*hd] in (c, h, d) order
        return m.reshape((1,) * (ndim - 1) + (out,))
    if transform == Transform.HEADS:
        h = mask.shape[0]
        out = param_shape[-1]
        hd = out // h
        m = jnp.repeat(mask, hd)
        return m.reshape((1,) * (ndim - 1) + (out,))
    raise ValueError(f"unhandled transform {transform}")


def kept_indices_for_axis(kept_groups: np.ndarray, transform: Transform,
                          axis_size: int, num_heads: int = 1,
                          num_groups: Optional[int] = None) -> np.ndarray:
    """Map kept group indices -> kept indices along the pruned axis.

    The compression-side index expansion (index_transform.py:11-30 and
    pruning_compression.py:296-316): head groups expand to head_dim runs;
    OUT/IN groups coarser than the axis (GroupNorm-style spread) expand to
    contiguous axis_size/num_groups runs when ``num_groups`` is given.
    """
    kept_groups = np.asarray(kept_groups)
    if transform in (Transform.OUT, Transform.IN, Transform.ACCESSORY):
        run = axis_size // num_groups if num_groups else 1
        if run > 1:
            return np.concatenate(
                [g * run + np.arange(run) for g in kept_groups]
            ) if len(kept_groups) else kept_groups
        return kept_groups
    if transform == Transform.QKV_HEADS:
        if len(kept_groups) == 0:
            return kept_groups.astype(np.int64)
        hd = axis_size // (3 * num_heads)
        per_comp = [
            c * num_heads * hd + h * hd + np.arange(hd)
            for c in range(3)
            for h in kept_groups
        ]
        return np.concatenate(per_comp)
    if transform == Transform.HEADS:
        if len(kept_groups) == 0:
            return kept_groups.astype(np.int64)
        hd = axis_size // num_heads
        return np.concatenate([h * hd + np.arange(hd) for h in kept_groups])
    raise ValueError(f"unhandled transform {transform}")


def group_sq_norms(group: NodeGroup, tree) -> jax.Array:
    """Sum over entries of per-group squared L2 norms — the shared kernel of
    magnitude scores and zero-group detection (node_group.py:178-278)."""
    total = jnp.zeros((group.num_groups,))
    for e in group.entries:
        if e.transform == Transform.NO_PRUNE:
            continue
        m = group_matrix(get_path(tree, e.path), e.transform,
                         group.num_groups, group.num_heads)
        total = total + jnp.sum(jnp.square(m.astype(jnp.float32)), axis=1)
    return total


def group_cols(group: NodeGroup, tree) -> int:
    """Total columns across entries' group matrices — the reference's
    ``group_cost`` (base_hybrid_sparse_optimizer.py:283-291)."""
    cols = 0
    for e in group.entries:
        if e.transform == Transform.NO_PRUNE:
            continue
        m = group_matrix(get_path(tree, e.path), e.transform,
                         group.num_groups, group.num_heads)
        cols += m.shape[1]
    return max(cols, 1)
