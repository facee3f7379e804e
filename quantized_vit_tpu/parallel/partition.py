"""Mesh construction and GSPMD partition rules.

The reference has NO parallelism (single CUDA device, train.py:265 —
SURVEY.md §2.4); this module is the scaling story mandated by BASELINE.json:
tensor-sharded weights over a device mesh with XLA-inserted collectives.

Sharding layout (Megatron-style column/row pairing so each block needs one
all-reduce per residual branch):
- qkv / fc1 kernels: column-sharded over 'model'  -> P(None, 'model')
- proj / fc2 kernels: row-sharded over 'model'    -> P('model', None)
- column-sharded layer biases: P('model'); row-sharded layer biases:
  replicated (added after the all-reduce)
- everything else (LN, embeddings, quant scalars): replicated
- activations / batch: P('data')

Rules are (regex, PartitionSpec) matched against '/'-joined param paths;
first match wins.
"""

from __future__ import annotations

import re
from typing import Any, List, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(shape: Sequence[int] = None,
                axis_names: Sequence[str] = ("data", "model"),
                devices=None) -> Mesh:
    """Build a Mesh over available devices. Default: all devices on 'data'
    for a 1D request, or the given shape."""
    devices = np.array(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names=axis_names)


# (pattern, spec) — matched with re.search against the '/'-joined path
VIT_PARTITION_RULES: List[Tuple[str, P]] = [
    (r"attn/qkv/kernel$", P(None, "model")),
    (r"attn/qkv/bias$", P("model")),
    (r"attn/proj/kernel$", P("model", None)),
    (r"mlp/fc1/kernel$", P(None, "model")),
    (r"mlp/fc1/bias$", P("model")),
    (r"mlp/fc2/kernel$", P("model", None)),
    (r"", P()),  # default: replicate
]


def shard_vit_artifact(art, mesh: Mesh):
    """Device_put an IN-MEMORY INT4 serving artifact with the same TP rules
    the artifact loader applies (artifact/vit.py:44-73): qkv/fc1
    column-sharded (w P(None,'model'), scale/bias vectors P('model')),
    proj/fc2 row-sharded (w P('model',None)), everything else replicated.
    """
    import dataclasses as _dc

    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    def qput(e, kind: str):
        w_spec = {"col": P(None, "model"), "row": P("model", None),
                  "rep": P()}[kind]
        def vec_spec(a):
            return (P("model") if kind == "col"
                    and getattr(a, "ndim", 0) == 1 else P())
        return _dc.replace(
            e,
            w=put(e.w, w_spec),
            scale=put(e.scale, vec_spec(e.scale)),
            bias=None if e.bias is None else put(e.bias, vec_spec(e.bias)),
            act={k: put(v, P()) for k, v in e.act.items()},
        )

    rep = lambda tree: jax.tree.map(lambda a: put(a, P()), tree)
    out = {
        "patch_embed": qput(art["patch_embed"], "rep"),
        "cls_token": put(art["cls_token"], P()),
        "pos_embed": put(art["pos_embed"], P()),
        "norm": rep(art["norm"]),
        "blocks": [
            {
                "norm1": rep(b["norm1"]),
                "qkv": qput(b["qkv"], "col"),
                "proj": qput(b["proj"], "row"),
                "norm2": rep(b["norm2"]),
                "fc1": qput(b["fc1"], "col"),
                "fc2": qput(b["fc2"], "row"),
            }
            for b in art["blocks"]
        ],
    }
    if "pre_logits" in art:
        out["pre_logits"] = rep(art["pre_logits"])
    if "head" in art:
        out["head"] = qput(art["head"], "rep")
    return out


def spec_for_path(path: str, rules=VIT_PARTITION_RULES) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return P()


def partition_specs(params: Any, rules=VIT_PARTITION_RULES):
    """Pytree of PartitionSpec matching ``params``' structure."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]

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

    specs = [spec_for_path(path_str(kp), rules) for kp, _ in flat]
    treedef = jax.tree_util.tree_structure(params)
    return jax.tree_util.tree_unflatten(treedef, specs)


def shard_params(params: Any, mesh: Mesh, rules=VIT_PARTITION_RULES):
    """Place a params pytree onto the mesh per the rules."""
    specs = partition_specs(params, rules)
    return jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs
    )


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Batch-dim sharding for activations/inputs."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))
