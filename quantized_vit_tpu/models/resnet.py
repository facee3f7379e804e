"""Residual CNN (ResNet, CIFAR-style BasicBlock) — the generic-CNN proof
point for the pruning-dependency machinery.

The reference's OTO library is model-agnostic: its integration tests
quantize torchvision ResNet-50 (tests/quantization/test_quant_model.py:31-
110) and trace arbitrary CNNs into node groups (dependency_graph/
pruning_dependency.py steps 0-10, incl. the residual-addition connected
components that tie every conv feeding a skip connection into one pruning
decision). This module provides the equivalent flax family so the graph
layer demonstrably handles residual CNNs, not just ViT/UltraNet:

- stem 3x3 conv -> BN -> ReLU
- stages of BasicBlocks: conv1(3x3, stride) -> BN -> ReLU -> conv2(3x3) ->
  BN, plus an identity skip or a 1x1 downsample conv+BN when the stride or
  width changes; out = ReLU(skip + branch)
- global average pool -> Dense head

All convs/dense are the LSFQ-quantizable QuantConv/QuantDense (the same
layers model_to_quantize_model swaps in — quant_model.py:15-82), so
`init_quant_params_tree` / GETA / export all apply unchanged.

Compressed subnets are explicit configs: ``widths`` (per-stage stream
width) and ``inner_widths`` (per-block conv1 width) — the functional
replacement for the reference's in-place module surgery.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import flax.linen as nn
import jax.numpy as jnp

from .layers import QuantConfig, QuantConv, QuantDense


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2)
    widths: Tuple[int, ...] = (16, 32, 64)
    stem_width: int = 16
    num_classes: int = 10
    in_channels: int = 3
    quant: QuantConfig = QuantConfig.off()
    # per-(stage, block) conv1 width for compressed subnets; None = stream
    # width (dense model)
    inner_widths: Optional[Tuple[Tuple[int, ...], ...]] = None

    def block_inner(self, s: int, b: int) -> int:
        if self.inner_widths is not None:
            return self.inner_widths[s][b]
        return self.widths[s]


class BasicBlock(nn.Module):
    cfg: ResNetConfig
    width: int          # stream (output) width of this stage
    inner: int          # conv1 output width (prunable independently)
    stride: int
    downsample: bool    # 1x1 conv on the skip path

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        c = self.cfg
        h = QuantConv(features=self.inner, kernel_size=(3, 3),
                      strides=(self.stride, self.stride), padding="SAME",
                      config=c.quant, use_bias=False, name="conv1")(x)
        h = nn.BatchNorm(use_running_average=deterministic,
                         momentum=0.9, epsilon=1e-5, name="bn1")(h)
        h = nn.relu(h)
        h = QuantConv(features=self.width, kernel_size=(3, 3),
                      strides=(1, 1), padding="SAME", config=c.quant,
                      use_bias=False, name="conv2")(h)
        h = nn.BatchNorm(use_running_average=deterministic,
                         momentum=0.9, epsilon=1e-5, name="bn2")(h)
        if self.downsample:
            x = QuantConv(features=self.width, kernel_size=(1, 1),
                          strides=(self.stride, self.stride),
                          padding="VALID", config=c.quant, use_bias=False,
                          name="down_conv")(x)
            x = nn.BatchNorm(use_running_average=deterministic,
                             momentum=0.9, epsilon=1e-5, name="down_bn")(x)
        return nn.relu(x + h)


class ResNet(nn.Module):
    cfg: ResNetConfig

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        c = self.cfg
        x = QuantConv(features=c.stem_width, kernel_size=(3, 3),
                      strides=(1, 1), padding="SAME", config=c.quant,
                      use_bias=False, name="stem_conv")(x)
        x = nn.BatchNorm(use_running_average=deterministic,
                         momentum=0.9, epsilon=1e-5, name="stem_bn")(x)
        x = nn.relu(x)
        for s, (n_blocks, width) in enumerate(zip(c.stage_sizes, c.widths)):
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                in_width = x.shape[-1]
                down = (stride != 1) or (in_width != width)
                x = BasicBlock(
                    c, width=width, inner=c.block_inner(s, b),
                    stride=stride, downsample=down,
                    name=f"stage{s}_block{b}",
                )(x, deterministic)
        x = jnp.mean(x, axis=(1, 2))  # global average pool
        x = QuantDense(features=c.num_classes, config=c.quant,
                       name="head")(x)
        return x


def resnet20(num_classes=10, quant=QuantConfig.off()):
    return ResNet(ResNetConfig(stage_sizes=(3, 3, 3), widths=(16, 32, 64),
                               num_classes=num_classes, quant=quant))


def resnet8(num_classes=10, quant=QuantConfig.off()):
    """Small variant for tests."""
    return ResNet(ResNetConfig(stage_sizes=(1, 1, 1), widths=(16, 32, 64),
                               num_classes=num_classes, quant=quant))
