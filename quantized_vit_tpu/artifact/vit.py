"""ViT INT4 serving artifact on disk, with optional sharded loading.

`save_vit_int4_artifact` persists the pytree `serve.export_vit_int4`
produces (packed-int4 weights, fused scales, activation-quant constants).
`load_vit_int4_artifact` restores it; given a mesh it device_puts every
weight with the partition rules from `parallel.partition` — the loader is
where GSPMD sharding enters the serving path (the reference's analogue is
the PE×SIMD re-tiling in qnn_mem_process.py:84-140, done at artifact-load
time instead of artifact-build time so one artifact serves any mesh shape).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import numpy as np

from ..configs import QuantConfig, ViTConfig
from .io import load_artifact_tree, save_artifact_tree


def save_vit_int4_artifact(out_dir: str, art: Dict[str, Any],
                           cfg: ViTConfig) -> str:
    meta = {"model": "vit_int4", "cfg": dataclasses.asdict(cfg)}
    # cfg dataclass contains a nested QuantConfig dataclass; asdict handles
    # it, but tuples become lists — normalized on load.
    return save_artifact_tree(out_dir, art, meta)


def _cfg_from_meta(meta: Dict[str, Any]) -> ViTConfig:
    raw = dict(meta["cfg"])
    q = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in raw.pop("quant").items()}
    q.pop("fused_vjp", None)  # a training-only field artifacts once saved
    for k in ("heads_per_block", "hidden_per_block"):
        if raw.get(k) is not None:
            raw[k] = tuple(raw[k])
    return ViTConfig(quant=QuantConfig(**q), **raw)


def load_vit_int4_artifact(in_dir: str, mesh=None):
    """Returns (artifact pytree, ViTConfig).

    With ``mesh``: packed weights load sharded along the output axis on the
    'model' mesh axis (column-parallel qkv/fc1, row-parallel proj/fc2 follow
    from the serving forward's layout) — everything else replicated.
    """
    put = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        col = {"qkv", "fc1"}
        row = {"proj", "fc2"}

        def put(path: str, arr: np.ndarray):
            parts = path.split(".")
            leaf = parts[-1]
            layer = parts[-2] if len(parts) >= 2 else ""
            spec = P()
            if leaf == "w" and arr.ndim == 2:
                if layer in col:
                    spec = P(None, "model")
                elif layer in row:
                    spec = P("model", None)
            elif leaf in ("scale", "bias") and layer in col and arr.ndim == 1:
                spec = P("model")
            return jax.device_put(arr, NamedSharding(mesh, spec))

    tree, meta = load_artifact_tree(in_dir, put=put)
    return tree, _cfg_from_meta(meta)
