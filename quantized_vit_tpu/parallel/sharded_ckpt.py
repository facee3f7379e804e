"""Orbax-backed sharded checkpointing for multi-host training/serving.

The reference checkpoints with single-process ``torch.save``/``torch.load``
(optimizer/utils.py:9-37, train.py:517-532) and pickles whole compressed
modules (pruning_compression.py:385). The form here (SURVEY.md §5
"Checkpoint / resume") is sharded on-disk arrays keyed by logical names —
each host writes only the shards it owns, and restore places every shard
directly on its target device without a host-side gather — plus a sidecar
manifest carrying the quant/prune metadata (schedules, frozen bit dicts,
kept-index maps) that is NOT array data.

Layout on disk:

    <path>/arrays/      orbax StandardCheckpointer tree (zarr shards)
    <path>/meta.pkl     pickled {"extra": ...} manifest (host 0 only)

Restore takes the target ``Mesh`` plus partition rules (the same
(regex, PartitionSpec) tables used to shard live params —
``parallel.partition.VIT_PARTITION_RULES``), so a checkpoint written on one
mesh can be restored onto a different topology: shapes/dtypes come from the
checkpoint's own metadata, shardings from the rules. With ``mesh=None`` the
tree restores replicated on the default device (single-host eval path).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import jax
from jax.sharding import Mesh, NamedSharding

from .partition import VIT_PARTITION_RULES, spec_for_path

_ARRAYS = "arrays"
_META = "meta.pkl"


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def _is_host_zero() -> bool:
    return jax.process_index() == 0


def save_sharded_checkpoint(path: str, params: Any,
                            extra: Optional[Dict] = None) -> str:
    """Write ``params`` (a pytree of possibly-sharded jax.Arrays) under
    ``path``. Every participating host must call this (orbax coordinates the
    per-shard writes); ``extra`` is written by host 0 only."""
    path = os.path.abspath(path)
    ckptr = _checkpointer()
    ckptr.save(os.path.join(path, _ARRAYS), params, force=True)
    ckptr.wait_until_finished()
    if _is_host_zero():
        with open(os.path.join(path, _META), "wb") as f:
            pickle.dump({"extra": extra or {}}, f)
    return path


def restore_sharded_checkpoint(
    path: str,
    mesh: Optional[Mesh] = None,
    rules=VIT_PARTITION_RULES,
) -> Tuple[Any, Dict]:
    """Restore ``(params, extra)``. With a ``mesh``, each array lands
    sharded per ``rules`` (matched against its '/'-joined tree path); the
    mesh need not match the one the checkpoint was written on."""
    path = os.path.abspath(path)
    ckptr = _checkpointer()
    arrays_path = os.path.join(path, _ARRAYS)

    if mesh is None:
        params = ckptr.restore(arrays_path)
    else:
        meta_tree = ckptr.metadata(arrays_path).item_metadata.tree

        def path_str(kp):
            parts = []
            for k in kp:
                if hasattr(k, "key"):
                    parts.append(str(k.key))
                elif hasattr(k, "idx"):
                    parts.append(str(k.idx))
                elif hasattr(k, "name"):
                    parts.append(str(k.name))
            return "/".join(parts)

        def abstract(kp, m):
            spec = spec_for_path(path_str(kp), rules)
            return jax.ShapeDtypeStruct(
                tuple(m.shape), m.dtype,
                sharding=NamedSharding(mesh, spec))

        abstract_tree = jax.tree_util.tree_map_with_path(
            abstract, meta_tree,
            is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
        params = ckptr.restore(arrays_path, abstract_tree)

    extra: Dict = {}
    meta_file = os.path.join(path, _META)
    if os.path.exists(meta_file):
        with open(meta_file, "rb") as f:
            extra = pickle.load(f).get("extra", {})
    return params, extra


def scan_sharded_checkpoint(ckpt_dir: str,
                            name: str = "ckpt") -> Optional[str]:
    """Latest sharded checkpoint directory by trailing step number —
    the directory analogue of optimizer/utils.py:24-37's glob-by-suffix."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, f"{name}_*")):
        if not os.path.isdir(p):
            continue
        m = re.search(r"_(\d+)$", p)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = p
    return best
