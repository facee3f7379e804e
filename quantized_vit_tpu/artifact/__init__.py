"""Artifact pipeline: the JAX counterpart of the reference's FPGA export.

The reference's deployment path (`4-bit quantization/torch_export.py` →
`qnn_param_reader.py` → `qnn_mem_process.py` → `ultranet_param_gen.py`)
packs 4-bit weights into PE×SIMD-tiled C++ HLS headers. ``hls`` still emits
those headers for the reference's FPGA accelerator. The ViT serving
artifact is npz arrays + a JSON manifest, weights ship as packed-int4 or
int8 levels, and the loader reapplies `NamedSharding` from the
partition-rule table when given a mesh.

The UltraNet and HLS exporters build on the flax model zoo, so they load on
first use; the ViT serving artifact (``vit``, ``io``, ``native``) imports
without flax.
"""

import importlib

from .io import save_artifact_tree, load_artifact_tree
from .vit import save_vit_int4_artifact, load_vit_int4_artifact
from .native import (
    native_available,
    pack_int4_host,
    unpack_int4_host,
    quantize_levels_host,
)

_LAZY = {
    "UltraNetExportConfig": "ultranet",
    "generate_ultranet_config": "ultranet",
    "export_ultranet_int": "ultranet",
    "save_ultranet_artifact": "ultranet",
    "load_ultranet_artifact": "ultranet",
    "export_ultranet_hls": "hls",
    "inc_bias_tiles": "hls",
    "int_bit_width": "hls",
    "pack_words": "hls",
    "tile_pe": "hls",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "native_available",
    "pack_int4_host",
    "unpack_int4_host",
    "quantize_levels_host",
    "save_artifact_tree",
    "load_artifact_tree",
    "save_vit_int4_artifact",
    "load_vit_int4_artifact",
    *_LAZY,
]
