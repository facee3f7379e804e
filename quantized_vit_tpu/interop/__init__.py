"""Torch-checkpoint interoperability.

Reference users hold PyTorch artifacts on disk: ImageNet-21k pretrained ViT
weights loaded at QViT_with_GETA/train.py:236-245, QAT checkpoints saved as
``{model, optimizer, args}`` dicts (train.py:517-532), and the UltraNet
``ultranet_4w4a.pt`` consumed by the FPGA export driver
(4-bit quantization/torch_export.py:8-12). This package converts those
state dicts into this framework's flax params pytrees (and back), so a
reference user can bring their existing checkpoints here without
retraining.
"""

from .npz_export import (
    export_reference_ultranet,
    ultranet_reference_arrays,
    ultranet_reference_config,
)
from .torch_import import (
    load_torch_checkpoint,
    normalize_state_dict,
    ultranet_params_from_torch,
    ultranet_params_to_torch,
    vit_params_from_torch,
    vit_params_to_torch,
)

__all__ = [
    "export_reference_ultranet",
    "ultranet_reference_arrays",
    "ultranet_reference_config",
    "load_torch_checkpoint",
    "normalize_state_dict",
    "ultranet_params_from_torch",
    "ultranet_params_to_torch",
    "vit_params_from_torch",
    "vit_params_to_torch",
]
