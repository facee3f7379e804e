"""UltraNet integer artifact pipeline (the FPGA-export replacement).

Reference flow (SURVEY.md §3.6): `torch_export.py` dumps conv weights + BN
params to npz + config.json; `ultranet_param_gen.py` drives
`qnn_param_reader.py`/`qnn_mem_process.py` to quantize weights to int, fold
BN+activation into integer (inc, bias) tables, SIMD-pack nibbles and emit
C++ HLS headers.

JAX flow (this module): one pass over the flax params/batch_stats pytree
produces the integer tensors :class:`UltraNetInt` consumes —
``weight_quantize_int`` levels and ``bn_act_quantize_int`` (inc, bias) — and
a config table mirroring `torch_export.py:15-71`'s per-layer geometry. The
nibble-packing for storage runs through the native C++ packer when built
(`quantized_vit_tpu.artifact.native`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..models.ultranet import ULTRANET_LAYERS, ULTRANET_OUT_CHANNELS
from ..quant.integer import bn_act_quantize_int, weight_quantize_int
from .io import load_artifact_tree, save_artifact_tree


@dataclasses.dataclass
class UltraNetExportConfig:
    """Per-pipeline export hyperparameters (ultranet_param_gen.py:14-22).

    The reference also carries per-layer SIMD/PE tables — an FPGA memory
    geometry with no meaning here; the packed-int4 layout plays that role.
    """

    w_bit: int = 4
    in_bit_first: int = 8   # first conv consumes 8-bit image levels
    a_bit: int = 4
    out_bit_last: int = 32  # last conv accumulates to f32 for the YOLO head
    l_shift: int = 8
    eps: float = 1e-5
    input_shape: Tuple[int, int, int] = (160, 320, 3)  # torch_export.py:150


def generate_ultranet_config(exp: UltraNetExportConfig,
                             channels: Any = None) -> List[Dict[str, Any]]:
    """Per-layer geometry table (torch_export.py:15-71): in/out channels,
    spatial in/out, kernel/stride/padding. ``channels`` overrides the dense
    per-conv out-channel counts (GETA-compressed subnets)."""
    h, w, c = exp.input_shape
    table = []
    in_ch = c
    for i, (feat, ks, pool) in enumerate(ULTRANET_LAYERS):
        if channels is not None:
            feat = int(channels[i])
        entry = {
            "name": f"conv_{i}",
            "in_shape": [h, w, in_ch],
            "k": ks, "s": 1, "p": ks // 2,
            "out_channels": feat,
            "w_bit": exp.w_bit,
            "in_bit": exp.in_bit_first if i == 0 else exp.a_bit,
            "out_bit": exp.a_bit,
            "l_shift": exp.l_shift,
            "maxpool_after": bool(pool),
        }
        if pool:
            h, w = h // 2, w // 2
        entry["out_shape"] = [h, w, feat]
        table.append(entry)
        in_ch = feat
    table.append({
        "name": f"conv_{len(ULTRANET_LAYERS)}",
        "in_shape": [h, w, in_ch],
        "k": 1, "s": 1, "p": 0,
        "out_channels": ULTRANET_OUT_CHANNELS,
        "w_bit": exp.w_bit,
        "in_bit": exp.a_bit,
        "out_bit": exp.out_bit_last,
        "l_shift": exp.l_shift,
        "maxpool_after": False,
        "out_shape": [h, w, ULTRANET_OUT_CHANNELS],
    })
    return table


def export_ultranet_int(params: Dict[str, Any],
                        batch_stats: Dict[str, Any],
                        exp: Optional[UltraNetExportConfig] = None
                        ) -> Dict[str, Any]:
    """Trained UltraNet params -> :class:`UltraNetInt` integer params.

    Per conv layer i<8: ``kernel_int`` (weight_quantize_int levels in
    ±(2^(w_bit-1)-1)) and folded-BN ``(inc, bias)`` integer tables
    (qnn_param_reader.py:45-67 semantics). Last conv: integer kernel + float
    bias (ultranet_param_gen.py:51-61).
    """
    exp = exp or UltraNetExportConfig()
    out: Dict[str, Any] = {}
    for i, (feat, ks, pool) in enumerate(ULTRANET_LAYERS):
        in_bit = exp.in_bit_first if i == 0 else exp.a_bit
        out[f"conv_{i}_kernel_int"] = weight_quantize_int(
            params[f"conv_{i}"]["kernel"], bit=exp.w_bit)
        inc, bias = bn_act_quantize_int(
            params[f"bn_{i}"]["scale"], params[f"bn_{i}"]["bias"],
            batch_stats[f"bn_{i}"]["mean"], batch_stats[f"bn_{i}"]["var"],
            exp.eps, w_bit=exp.w_bit, in_bit=in_bit, out_bit=exp.a_bit,
            l_shift=exp.l_shift,
        )
        out[f"conv_{i}_inc"] = inc
        out[f"conv_{i}_bias_int"] = bias
    last = f"conv_{len(ULTRANET_LAYERS)}"
    out[f"{last}_kernel_int"] = weight_quantize_int(
        params[last]["kernel"], bit=exp.w_bit)
    out[f"{last}_bias"] = jnp.asarray(params[last]["bias"], jnp.float32)
    return out


def save_ultranet_artifact(out_dir: str, params, batch_stats,
                           exp: Optional[UltraNetExportConfig] = None) -> str:
    """Full export: integer params + config table -> artifact dir."""
    exp = exp or UltraNetExportConfig()
    int_params = export_ultranet_int(params, batch_stats, exp)
    channels = [int(jnp.shape(params[f"conv_{i}"]["kernel"])[-1])
                for i in range(len(ULTRANET_LAYERS))]
    meta = {
        "model": "ultranet",
        "config": generate_ultranet_config(exp, channels=channels),
        "export": dataclasses.asdict(exp),
    }
    return save_artifact_tree(out_dir, int_params, meta)


def load_ultranet_artifact(in_dir: str):
    """Returns (int_params for UltraNetInt.apply, meta)."""
    tree, meta = load_artifact_tree(
        in_dir, dataclass_registry={
            "UltraNetExportConfig": UltraNetExportConfig})
    return tree, meta
