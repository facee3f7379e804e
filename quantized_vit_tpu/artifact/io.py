"""Generic artifact serialization: nested pytree -> npz arrays + JSON manifest.

The reference pickles whole torch modules (pruning_compression.py:385,
predict.py:43) because pruning changes tensor shapes; here shapes live in
the manifest so loading never needs to execute code — the npz holds flat
arrays keyed by tree path, the manifest holds structure + static metadata
(layer formats, configs, scalars).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
FORMAT_VERSION = 1


def _encode(node, arrays: Dict[str, np.ndarray], path: str):
    from ..serve.vit_int4 import QLayerArtifact

    if node is None:
        return {"__none__": True}
    if isinstance(node, QLayerArtifact):
        return {
            "__qlayer__": {
                "fmt": node.fmt,
                "act_pow": bool(node.act_pow),
                "top": int(node.top),
                "w": _encode(node.w, arrays, f"{path}.w"),
                "scale": _encode(node.scale, arrays, f"{path}.scale"),
                "bias": _encode(node.bias, arrays, f"{path}.bias"),
                "act": _encode(node.act, arrays, f"{path}.act"),
            }
        }
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {
            "__dataclass__": type(node).__name__,
            "fields": {
                f.name: _encode(getattr(node, f.name), arrays,
                                f"{path}.{f.name}")
                for f in dataclasses.fields(node)
            },
        }
    if isinstance(node, dict):
        return {"__dict__": {k: _encode(v, arrays, f"{path}.{k}")
                             for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {
            "__list__": [_encode(v, arrays, f"{path}[{i}]")
                         for i, v in enumerate(node)],
            "tuple": isinstance(node, tuple),
        }
    if isinstance(node, (bool, int, float, str)):
        return {"__scalar__": node}
    if hasattr(node, "shape"):
        arrays[path] = np.asarray(node)
        return {"__arr__": path}
    raise TypeError(f"cannot serialize {type(node)} at {path}")


def _decode(enc, arrays, dataclass_registry: Dict[str, type],
            put: Optional[Callable[[str, np.ndarray], Any]]):
    from ..serve.vit_int4 import QLayerArtifact

    if "__none__" in enc:
        return None
    if "__qlayer__" in enc:
        q = enc["__qlayer__"]
        act = _decode(q["act"], arrays, dataclass_registry, put)
        # format v1 artifacts carried top inside the act dict (as an array);
        # it is static pytree metadata now
        top = q.get("top")
        if top is None:
            top = int(np.asarray(act.pop("top")))
        else:
            act.pop("top", None)
        return QLayerArtifact(
            w=_decode(q["w"], arrays, dataclass_registry, put),
            scale=_decode(q["scale"], arrays, dataclass_registry, put),
            bias=_decode(q["bias"], arrays, dataclass_registry, put),
            act=act, fmt=q["fmt"], act_pow=q["act_pow"], top=int(top),
        )
    if "__dataclass__" in enc:
        cls = dataclass_registry[enc["__dataclass__"]]
        fields = {k: _decode(v, arrays, dataclass_registry, put)
                  for k, v in enc["fields"].items()}
        # tuples serialized as lists inside dataclasses get restored by the
        # dataclass's own type hints only loosely; callers relying on
        # hashability should normalize.
        return cls(**fields)
    if "__dict__" in enc:
        return {k: _decode(v, arrays, dataclass_registry, put)
                for k, v in enc["__dict__"].items()}
    if "__list__" in enc:
        out = [_decode(v, arrays, dataclass_registry, put)
               for v in enc["__list__"]]
        return tuple(out) if enc.get("tuple") else out
    if "__scalar__" in enc:
        return enc["__scalar__"]
    if "__arr__" in enc:
        key = enc["__arr__"]
        arr = arrays[key]
        if put is not None:
            return put(key, arr)
        return jnp.asarray(arr)
    raise ValueError(f"bad manifest node {list(enc)[:3]}")


def save_artifact_tree(out_dir: str, tree, extra_meta: Optional[Dict] = None):
    """Write ``tree`` (dicts/lists/arrays/QLayerArtifact/dataclasses) to
    ``out_dir``/{manifest.json, arrays.npz}."""
    os.makedirs(out_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    enc = _encode(tree, arrays, "root")
    manifest = {
        "format_version": FORMAT_VERSION,
        "meta": extra_meta or {},
        "tree": enc,
    }
    np.savez(os.path.join(out_dir, ARRAYS), **arrays)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def load_artifact_tree(in_dir: str,
                       dataclass_registry: Optional[Dict[str, type]] = None,
                       put: Optional[Callable[[str, np.ndarray], Any]] = None):
    """Load an artifact dir. ``put(path, np_array)`` overrides device
    placement per array — pass a closure applying NamedSharding for
    multi-chip serving. Returns (tree, meta)."""
    with open(os.path.join(in_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest['format_version']} != "
            f"{FORMAT_VERSION}")
    arrays = dict(np.load(os.path.join(in_dir, ARRAYS)))
    registry = dict(dataclass_registry or {})
    from ..configs import QuantConfig, ViTConfig

    registry.setdefault("ViTConfig", ViTConfig)
    registry.setdefault("QuantConfig", QuantConfig)
    tree = _decode(manifest["tree"], arrays, registry, put)
    return tree, manifest["meta"]
