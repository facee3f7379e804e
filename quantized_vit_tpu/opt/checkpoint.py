"""Checkpoint save/load/scan for (params, GETA state).

Reference: only_train_once/optimizer/utils.py:9-37 (torch.save/load + glob
scan by trailing step number). Form here: a directory of .npz shards
for array pytrees plus a pickled metadata dict — no framework pickling of
live modules (compressed models are reconstructed from the manifest instead
of pickled whole, unlike predict.py:43).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(path: str, params, opt_state: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> str:
    """Write `<path>.npz` (params) + `<path>.meta.pkl` (optimizer/extra)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten(params))
    meta = {"opt_state": opt_state, "extra": extra or {}}
    with open(path + ".meta.pkl", "wb") as f:
        pickle.dump(meta, f)
    return path


def load_checkpoint(path: str) -> Tuple[Any, Optional[Dict], Dict]:
    with np.load(path + ".npz") as z:
        params = _unflatten({k: z[k] for k in z.files})
    meta = {"opt_state": None, "extra": {}}
    if os.path.exists(path + ".meta.pkl"):
        with open(path + ".meta.pkl", "rb") as f:
            meta = pickle.load(f)
    return params, meta["opt_state"], meta["extra"]


def scan_checkpoint(ckpt_dir: str, name: str = "ckpt") -> Optional[str]:
    """Latest checkpoint base path by trailing step number
    (optimizer/utils.py:24-37)."""
    paths = glob.glob(os.path.join(ckpt_dir, f"{name}_*.npz"))
    best, best_step = None, -1
    for p in paths:
        m = re.search(r"_(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = p[: -len(".npz")]
    return best
