"""FPGA HLS header export — full parity with the reference's generator.

The reference's deployment artifact for UltraNet is a pair of C++ headers
consumed by an external FPGA accelerator (`qnn_mem_process.py:228-443`,
driven by `ultranet_param_gen.py:26-64`): per layer, int-quantized weights
are SIMD-packed into big two's-complement words, re-tiled into a
``[PE][W_TILES]`` array of `ap_uint` literals, the folded-BN integer
``(inc, bias)`` tables into ``[PE][A_TILES]`` `ap_int` arrays with derived
bit widths, plus `#define` geometry macros. The JAX serving path doesn't
need any of this (see `artifact/ultranet.py`), but a reference user
deploying to the same FPGA target does — so this module reproduces the
artifact exactly from the flax params pytree.

Semantics reproduced (all asserted against the reference generator in
tests/artifact/test_hls.py):

- ``pack_words``     = array_to_string over SIMD slices (qnn_mem_process.py:
                       11-24, 84-108): LSB-first, two's complement at
                       ``elem_bit``, arbitrary-precision result.
- ``tile_pe``        = the PE re-tiling loop (qnn_mem_process.py:110-127):
                       tile index runs row-blocks-of-PE outer, SIMD word
                       inner.
- ``inc_bias_tiles`` = reshape(-1, PE).T (qnn_mem_process.py:130-140).
- ``int_bit_width``  = max-abs binary length + sign bit (qnn_mem_process.py:
                       271-285).
- header text        = w_to_hls_init_str / inc_to_hls_init_str /
                       bias_to_hls_init_str / *_config_str formats
                       (qnn_mem_process.py:228-318, 332-443).

Layout note: torch conv weights are [O, I, K, K] and the reference
transposes to [O, K, K, I] before flattening (qnn_mem_process.py:152-154);
flax kernels are [K, K, I, O] (HWIO), so the same OKKI order is
``moveaxis(-1, 0)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..models.ultranet import ULTRANET_LAYERS
from ..quant.integer import bn_act_quantize_int, weight_quantize_int
from .ultranet import UltraNetExportConfig, generate_ultranet_config

# Per-layer SIMD/PE memory geometry (ultranet_param_gen.py:21-22, first 9
# entries — the conv_0..conv_8 pipeline actually driven there).
ULTRANET_SIMD = (3, 16, 16, 16, 8, 8, 8, 8, 8)
ULTRANET_PE = (16, 8, 8, 4, 2, 2, 2, 2, 2)


def pack_words(rows: np.ndarray, elem_bit: int, simd: int) -> List[List[int]]:
    """Pack each row's values into big ints, ``simd`` values per word.

    Values are taken LSB-first within a word, each encoded two's-complement
    at ``elem_bit`` bits; a ragged tail (row length not divisible by simd)
    packs into one final shorter word, as the reference does.
    """
    rows = np.asarray(rows)
    out: List[List[int]] = []
    mask = (1 << elem_bit) - 1
    for row in rows:
        words = []
        for start in range(0, len(row), simd):
            chunk = row[start:start + simd]
            word = 0
            for lane, v in enumerate(chunk):
                word |= (int(v) & mask) << (elem_bit * lane)
            words.append(word)
        out.append(words)
    return out


def tile_pe(words: Sequence[Sequence[int]], pe: int) -> List[List[int]]:
    """Re-tile ``[O][T0]`` SIMD words into ``[PE][W_TILES]``: PE adjacent
    output channels stream in lockstep, tiles advance word-major within each
    block of PE rows."""
    n_rows, t0 = len(words), len(words[0])
    if n_rows % pe != 0:
        raise ValueError(f"out channels {n_rows} not divisible by pe {pe}")
    tiles = t0 * (n_rows // pe)
    res = [[0] * tiles for _ in range(pe)]
    t = 0
    for blk in range(n_rows // pe):
        for j in range(t0):
            for p in range(pe):
                res[p][t] = words[blk * pe + p][j]
            t += 1
    return res


def inc_bias_tiles(vec: np.ndarray, pe: int) -> np.ndarray:
    """Per-channel integer vector -> [PE][A_TILES]."""
    return np.asarray(vec).reshape(-1, pe).T


def int_bit_width(arr) -> int:
    """Bits for the max magnitude plus a sign bit."""
    abs_max = int(np.abs(np.asarray(arr)).max())
    return len(bin(abs_max)) - 2 + 1


def _array_init_str(arr2d) -> str:
    return ",\n".join(
        "{\"" + "\", \"".join(hex(int(v)) for v in row) + "\"}"
        for row in arr2d
    ) + "};\n"


def w_init_str(name: str, w: Sequence[Sequence[int]], w_bit: int, pe: int,
               simd: int) -> str:
    res = f"// {name}_w\n"
    res += "//PEs = %d, SIMD = %d\n" % (pe, simd)
    res += "//bit = %d\n" % w_bit
    res += f"const ap_uint<{w_bit * simd}> {name}_w"
    res += "[%d][%d] = {\n" % (len(w), len(w[0]))
    return res + _array_init_str(w)


def _vec_init_str(kind: str, name: str, arr: np.ndarray, bit: int) -> str:
    res = f"// {kind}\n"
    res += f"// {name}_{kind}\n"
    res += "// w_bit = %d\n" % bit
    res += f"const ap_int<{bit}> {name}_{kind}"
    res += "[%d][%d] = {\n" % (arr.shape[0], arr.shape[1])
    return res + _array_init_str(arr)


def config_macro(name: str, key: str, value: int) -> str:
    return "#define %s_%s %d \n" % (name.upper(), key.upper(), int(value))


class HLSLayer:
    """One fused conv+BN+act layer in hardware memory layout."""

    def __init__(self, name: str, entry: Dict[str, Any], pe: int, simd: int,
                 last: bool = False):
        self.name = name
        self.entry = entry
        self.pe = pe
        self.simd = simd
        self.last = last
        self.w: List[List[int]] = []
        self.inc: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None
        self.w_tiles = 0
        self.a_tiles = 0
        self.inc_bit = 0
        self.bias_bit = 0

    def process(self, kernel_int: np.ndarray,
                inc: Optional[np.ndarray] = None,
                bias: Optional[np.ndarray] = None):
        # flax HWIO -> [O, K, K, I] -> [O, K*K*I]
        okki = np.moveaxis(np.asarray(kernel_int), -1, 0)
        return self._finish(okki.reshape(okki.shape[0], -1), inc, bias)

    def process_linear(self, kernel_int: np.ndarray,
                       inc: Optional[np.ndarray] = None,
                       bias: Optional[np.ndarray] = None,
                       after_conv_shape: Optional[tuple] = None):
        """Dense layer path (QNNLayerMemProcess.linear, qnn_mem_process.py:
        194-218). flax kernels are [in, out] -> [O, I]; when the previous
        layer was a conv, ``after_conv_shape`` = that conv's output
        [H, W, C] (flax order) so the flattened in-dim reorders from the
        torch [C, H, W] flatten to the hardware's [H, W, C] stream order —
        with flax inputs the flatten is ALREADY [H, W, C]-major, so no
        reorder is needed and the arg only validates the length."""
        w = np.asarray(kernel_int).T  # [O, I]
        if after_conv_shape is not None:
            h, wd, c = after_conv_shape
            if w.shape[1] != h * wd * c:
                raise ValueError(
                    f"in-dim {w.shape[1]} != prod{after_conv_shape}")
        return self._finish(w, inc, bias)

    def _finish(self, flat_oi: np.ndarray, inc, bias):
        words = pack_words(flat_oi, self.entry["w_bit"], self.simd)
        self.w = tile_pe(words, self.pe)
        self.w_tiles = len(self.w[0])
        if not self.last:
            self.inc = inc_bias_tiles(inc, self.pe)
            self.bias = inc_bias_tiles(bias, self.pe)
            self.a_tiles = self.inc.shape[1]
            self.inc_bit = int_bit_width(self.inc)
            self.bias_bit = int_bit_width(self.bias)
        return self

    def param_str(self) -> str:
        res = w_init_str(self.name, self.w, self.entry["w_bit"], self.pe,
                         self.simd)
        if not self.last:
            res += _vec_init_str("inc", self.name, self.inc, self.inc_bit)
            res += _vec_init_str("bias", self.name, self.bias, self.bias_bit)
        return res

    def config_str(self) -> str:
        e = self.entry
        if "in_len" in e:
            return self._linear_config_str()
        res = f"// {self.name}\n"
        for key, val in (("K", e["k"]), ("S", e["s"]), ("P", e["p"])):
            res += config_macro(self.name, key, val)
        # reference config.json is [C, H, W]; ours is [H, W, C]
        ih, iw, ic = e["in_shape"]
        oh, ow, oc = e["out_shape"]
        for key, val in (("IFM_CH", ic), ("IFM_ROW", ih), ("IFM_COL", iw),
                         ("OFM_CH", oc), ("OFM_ROW", oh), ("OFM_COL", ow),
                         ("SIMD", self.simd), ("PE", self.pe),
                         ("IN_BIT", e["in_bit"])):
            res += config_macro(self.name, key, val)
        if not self.last:
            res += config_macro(self.name, "OUT_BIT", e["out_bit"])
        res += config_macro(self.name, "W_BIT", e["w_bit"])
        if not self.last:
            res += config_macro(self.name, "INC_BIT", self.inc_bit)
            res += config_macro(self.name, "BIAS_BIT", self.bias_bit)
        res += config_macro(self.name, "W_TILES", self.w_tiles)
        if not self.last:
            res += config_macro(self.name, "A_TILES", self.a_tiles)
        res += config_macro(self.name, "L_SHIFT", e["l_shift"])
        res += "\n"
        return res

    def _linear_config_str(self) -> str:
        """linear_config_str / last_linear_config_str formats
        (qnn_mem_process.py:408-446): last_linear omits OUT/INC/BIAS bits,
        the tile counts, and the trailing blank line."""
        e = self.entry
        res = f"// {self.name}\n"
        res += config_macro(self.name, "IN_LEN", e["in_len"])
        res += config_macro(self.name, "OUT_LEN", e["out_len"])
        res += config_macro(self.name, "SIMD", self.simd)
        res += config_macro(self.name, "PE", self.pe)
        res += config_macro(self.name, "IN_BIT", e["in_bit"])
        if not self.last:
            res += config_macro(self.name, "OUT_BIT", e["out_bit"])
        res += config_macro(self.name, "W_BIT", e["w_bit"])
        if not self.last:
            res += config_macro(self.name, "INC_BIT", self.inc_bit)
            res += config_macro(self.name, "BIAS_BIT", self.bias_bit)
            res += config_macro(self.name, "W_TILES", self.w_tiles)
            res += config_macro(self.name, "A_TILES", self.a_tiles)
        res += config_macro(self.name, "L_SHIFT", e["l_shift"])
        if not self.last:
            res += "\n"
        return res


def export_ultranet_hls(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        out_dir: str,
                        exp: Optional[UltraNetExportConfig] = None,
                        simd: Sequence[int] = ULTRANET_SIMD,
                        pe: Sequence[int] = ULTRANET_PE) -> Dict[str, str]:
    """Emit `param.h` / `config.h` / `last_bias.npy|.bin` into ``out_dir``
    from trained flax UltraNet params (the `ultranet_param_gen.py` flow).

    The PE tiling requires out_channels %% PE == 0 (qnn_mem_process.py:90
    asserts the same); GETA-pruned checkpoints can break that, so each
    layer's PE degrades to gcd(out_channels, PE) — config.h carries the
    effective PE, which is exactly what the accelerator HLS rebuild reads.

    Returns {"param": ..., "config": ...} header texts (also written).
    """
    import math

    exp = exp or UltraNetExportConfig()
    channels = [int(np.shape(params[f"conv_{i}"]["kernel"])[-1])
                for i in range(len(ULTRANET_LAYERS))]
    pe = [math.gcd(ch, int(p_)) for ch, p_ in zip(channels, pe)] +         [math.gcd(36, int(pe[len(ULTRANET_LAYERS)]))]
    table = {e["name"]: e
             for e in generate_ultranet_config(exp, channels=channels)}
    n = len(ULTRANET_LAYERS)
    param_parts: List[str] = []
    config_parts: List[str] = []
    for i in range(n):
        name = f"conv_{i}"
        e = table[name]
        kernel_int = weight_quantize_int(params[name]["kernel"],
                                         bit=e["w_bit"])
        inc, bias = bn_act_quantize_int(
            params[f"bn_{i}"]["scale"], params[f"bn_{i}"]["bias"],
            batch_stats[f"bn_{i}"]["mean"], batch_stats[f"bn_{i}"]["var"],
            exp.eps, w_bit=e["w_bit"], in_bit=e["in_bit"],
            out_bit=e["out_bit"], l_shift=e["l_shift"],
        )
        layer = HLSLayer(name, e, pe[i], simd[i]).process(
            np.asarray(kernel_int), np.asarray(inc), np.asarray(bias))
        param_parts.append(layer.param_str())
        config_parts.append(layer.config_str())

    name = f"conv_{n}"
    e = table[name]
    kernel_int = weight_quantize_int(params[name]["kernel"], bit=e["w_bit"])
    layer = HLSLayer(name, e, pe[n], simd[n], last=True).process(
        np.asarray(kernel_int))
    param_parts.append(layer.param_str())
    config_parts.append(layer.config_str())

    os.makedirs(out_dir, exist_ok=True)
    param_text = "".join(param_parts)
    config_text = "".join(config_parts)
    with open(os.path.join(out_dir, "param.h"), "w") as f:
        f.write(param_text)
    with open(os.path.join(out_dir, "config.h"), "w") as f:
        f.write(config_text)
    last_bias = np.asarray(params[name]["bias"], np.float32)
    np.save(os.path.join(out_dir, "last_bias.npy"), last_bias)
    last_bias.tofile(os.path.join(out_dir, "last_bias.bin"))
    return {"param": param_text, "config": config_text}
