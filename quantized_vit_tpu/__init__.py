"""quantized_vit_tpu — INT4 quantization + pruning framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
repo LongAoTianxia/Quantized_ViT (see SURVEY.md at the repository root):

- ``quant``    — LSFQ learned-scale quantizer math (custom_vjp), DoReFa STE
                 quantizers, integer export math, bit-width algebra, INT4 packing.
- ``ops``      — int8 x int4/int8 matmuls with fused quantize prologue and
                 dequant epilogue, and attention, as plain XLA.
- ``models``   — flax ViT family + UltraNet with quantized layers.
- ``graph``    — pruning-dependency analysis over parameter pytrees.
- ``opt``      — GETA / HESSO hybrid sparse+quant optimizers (optax-style).
- ``compress`` — subnet materialization (physical slicing of pruned groups).
- ``artifact`` — artifact pipeline (packed weights + scales + folded BN).
- ``parallel`` — mesh construction and GSPMD partition rules.
- ``serve``    — integer ViT forward (single device, TP, FSDP), its float
                 reference, continuous-batching serving engine.
"""

__version__ = "0.1.0"
