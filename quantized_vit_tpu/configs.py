"""Model and quantization configuration, importable without flax.

The serving path (``serve/``, ``artifact/vit.py``, ``cli/serve.py``) needs
the configuration dataclasses but none of the flax modules, so they live
here; ``models.vit`` and ``models.layers`` re-export them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization configuration for a model (hashable, jit-safe).

    Mirrors the reference's QuantizationType/QuantizationMode enums
    (quant_layers.py:20-29) plus the clip ranges (init_quantization defaults,
    quant_layers.py:311-312).
    """

    enabled: bool = True
    nonlinear: bool = True          # SYMMETRIC_NONLINEAR vs SYMMETRIC_LINEAR
    use_dge: bool = False           # DGE quantizer (weights only)
    quantize_acts: bool = True      # WEIGHT_AND_ACTIVATION vs WEIGHT_ONLY
    weight_clip: Tuple[float, float] = (-2.0, 2.0)
    act_clip: Tuple[float, float] = (-2.0, 2.0)
    init_bits: float = 32.0         # bits at initialization (train.py:247 uses 32)
    dge_bits: float = 4.0
    # Mixed-precision QAT (the f32-only reference has no equivalent): run
    # the DENSE/CONV dots in bf16 with f32 accumulation while ALL quantizer
    # math — fake-quant forward, the (d, q_m, t) custom-VJP grads,
    # LN/softmax — stays f32. Fake-quant values are exact multiples of d in
    # f32; the bf16 cast rounds them to 8 mantissa bits inside the dot only.
    matmul_dtype: Optional[str] = None  # None (f32) | "bfloat16"

    @staticmethod
    def off() -> "QuantConfig":
        return QuantConfig(enabled=False)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    representation_size: Optional[int] = None  # pre-logits dim (in21k)
    drop_ratio: float = 0.0
    attn_drop_ratio: float = 0.0
    drop_path_ratio: float = 0.0
    quant: QuantConfig = QuantConfig.off()
    # Per-block overrides for compressed subnets (compress/): after head /
    # hidden pruning blocks have non-uniform widths (pruning_compression.py
    # slices the torch modules in place; here the slim config is explicit).
    heads_per_block: Optional[Tuple[int, ...]] = None
    hidden_per_block: Optional[Tuple[int, ...]] = None

    def block_heads(self, i: int) -> int:
        return (self.heads_per_block[i] if self.heads_per_block is not None
                else self.num_heads)

    def block_hidden(self, i: int) -> int:
        return (self.hidden_per_block[i] if self.hidden_per_block is not None
                else int(self.embed_dim * self.mlp_ratio))

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # + cls token (vit_model.py:277, 297)
