"""UltraNet 4-bit CNN + YOLO detection head (flax).

JAX re-design of `4-bit quantization/mymodel.py`:

- 8x [DoReFa-quantized 3x3 conv (W4) -> BatchNorm -> 4-bit activation quant]
  with MaxPools after layers 1-4, then a 1x1 quantized conv to 36 channels
  (mymodel.py:62-128; W_BIT = A_BIT = 4 at :65-66).
- YOLOLayer decodes xywh/conf with 6 anchors of (20, 20), 6 outputs per
  anchor (mymodel.py:23-60): training returns raw predictions reshaped to
  [B, na, ny, nx, no]; inference applies sigmoid xy + grid offset, exp wh x
  anchors, stride rescale, sigmoid obj/cls (mymodel.py:45-60).

Also provides :class:`UltraNetInt` — the folded-BN *integer* inference
variant that consumes the artifact pipeline's int weights and (inc, bias)
tables (the JAX analogue of what the reference's generated FPGA HLS headers
compute; quantization.py:68-89, SURVEY.md §3.6).

Layout: NHWC. Channel config mirrors mymodel.py:73-124.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from ..quant.dorefa import (
    fold_batchnorm,
    fold_batchnorm_affine,
    quantize_activation,
    quantize_weight,
)
from ..quant.integer import requantize_int

# (features, kernel, maxpool_after) per conv block (mymodel.py:71-124)
ULTRANET_LAYERS = (
    (16, 3, True),
    (32, 3, True),
    (64, 3, True),
    (64, 3, True),
    (64, 3, False),
    (64, 3, False),
    (64, 3, False),
    (64, 3, False),
)
ULTRANET_OUT_CHANNELS = 36
ULTRANET_ANCHORS = ((20.0, 20.0),) * 6  # mymodel.py:127
W_BIT = 4
A_BIT = 4


class DoReFaConv(nn.Module):
    """Conv2d_Q (quant_ultra.py:76-91): weights DoReFa-quantized each forward."""

    features: int
    kernel_size: int
    w_bit: int = W_BIT
    strides: int = 1
    padding: Any = "SAME"
    use_bias: bool = False

    @nn.compact
    def __call__(self, x):
        kernel = self.param(
            "kernel",
            nn.initializers.kaiming_normal(),
            (self.kernel_size, self.kernel_size, x.shape[-1], self.features),
            jnp.float32,
        )
        kernel_q = quantize_weight(kernel, self.w_bit)
        y = jax.lax.conv_general_dilated(
            x,
            kernel_q,
            window_strides=(self.strides, self.strides),
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        if self.use_bias:
            y = y + self.param("bias", nn.initializers.zeros, (self.features,), jnp.float32)
        return y


class DoReFaDense(nn.Module):
    """Linear_Q (quant_ultra.py:210-222): Dense with DoReFa-quantized weight.

    The activation is NOT quantized here (the reference composes
    ``activation_quantize_fn`` separately) — only the kernel goes through
    tanh -> normalize -> signed (w_bit-1)-bit levels each forward.
    """

    features: int
    w_bit: int = W_BIT
    use_bias: bool = True

    @nn.compact
    def __call__(self, x):
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (x.shape[-1], self.features),
            jnp.float32,
        )
        y = jnp.dot(x, quantize_weight(kernel, self.w_bit))
        if self.use_bias:
            y = y + self.param("bias", nn.initializers.zeros,
                               (self.features,), jnp.float32)
        return y


class DoReFaBatchNorm(nn.Module):
    """BatchNorm2d_Q (quant_ultra.py:94-132): quantized folded BatchNorm.

    The reference folds γ, β and the RUNNING statistics into a per-channel
    affine (w, b), quantizes both to signed ``w_bit`` levels in [-1, 1], and
    applies ``w_q * x + b_q`` — in training as well as eval, and without ever
    updating the running stats (its F.batch_norm call uses zeroed mean /
    unit var / eps 0 with training=False). Reproduced exactly: running
    stats live read-only in the ``batch_stats`` collection (loaded from a
    checkpoint or left at init), and the forward is the quantized affine.

    Works on any NHWC-like layout — the channel axis is last.
    """

    w_bit: int = W_BIT
    eps: float = 1e-5

    @nn.compact
    def __call__(self, x):
        feat = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (feat,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (feat,), jnp.float32)
        mean = self.variable("batch_stats", "mean",
                             lambda: jnp.zeros((feat,), jnp.float32))
        var = self.variable("batch_stats", "var",
                            lambda: jnp.ones((feat,), jnp.float32))
        w_q, b_q = fold_batchnorm(scale, bias, mean.value, var.value,
                                  self.eps, self.w_bit)
        return x * w_q + b_q


class DoReFaBatchNorm1d(nn.Module):
    """BatchNorm1d_Q (quant_ultra.py:135-207).

    Reference quirk, reproduced faithfully: the forward computes the folded
    (w, b) AND a quantized ``w_q = uniform_quantize(w)`` — but then passes
    the UNQUANTIZED ``w, b`` to F.batch_norm (quant_ultra.py:196-207), so
    the layer is effectively a folded-BN affine with no quantization.
    In training mode F.batch_norm normalizes by the current batch statistics
    (biased variance, zero mean / unit var buffers discarded); in eval mode
    the fake stats make it exactly ``w * x + b``.
    """

    w_bit: int = W_BIT
    eps: float = 1e-5
    momentum: float = 0.1

    @nn.compact
    def __call__(self, x, train: bool = False):
        feat = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (feat,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (feat,), jnp.float32)
        mean = self.variable("batch_stats", "mean",
                             lambda: jnp.zeros((feat,), jnp.float32))
        var = self.variable("batch_stats", "var",
                            lambda: jnp.ones((feat,), jnp.float32))
        w, b = fold_batchnorm_affine(scale, bias, mean.value, var.value,
                                     self.eps)
        if train:
            # batch-statistics normalization with eps=0 and the folded affine
            axes = tuple(range(x.ndim - 1))
            bm = jnp.mean(x, axis=axes)
            bv = jnp.var(x, axis=axes)  # biased, as F.batch_norm uses
            return (x - bm) * jax.lax.rsqrt(bv) * w + b
        return x * w + b


def yolo_decode(p, img_size, anchors=ULTRANET_ANCHORS, num_outputs=6):
    """YOLOLayer inference decode (mymodel.py:32-60).

    p: [B, ny, nx, na*no] conv output (NHWC). Returns (io, p_raw):
      io  [B, na*ny*nx, no] — decoded boxes in pixels + sigmoided conf
      p_raw [B, na, ny, nx, no] — raw predictions (the training output)
    """
    b, ny, nx, _ = p.shape
    na = len(anchors)
    no = num_outputs
    stride = max(img_size) / max(nx, ny)

    p = p.reshape(b, ny, nx, na, no)
    p = jnp.transpose(p, (0, 3, 1, 2, 4))  # [B, na, ny, nx, no]

    ys, xs = jnp.meshgrid(jnp.arange(ny), jnp.arange(nx), indexing="ij")
    grid_xy = jnp.stack([xs, ys], axis=-1).astype(p.dtype)  # [ny, nx, 2]
    anchor_wh = (
        jnp.asarray(anchors, p.dtype).reshape(1, na, 1, 1, 2) / stride
    )

    xy = jax.nn.sigmoid(p[..., :2]) + grid_xy[None, None]
    wh = jnp.exp(p[..., 2:4]) * anchor_wh
    boxes = jnp.concatenate([xy, wh], axis=-1) * stride
    conf = jax.nn.sigmoid(p[..., 4:])
    io = jnp.concatenate([boxes, conf], axis=-1)
    return io.reshape(b, -1, no), p


class UltraNet(nn.Module):
    """UltraNetQua (mymodel.py:62-143), W4A4 DoReFa QAT network.

    ``train`` mode returns the raw YOLO predictions; eval returns
    (decoded, raw) like the reference.
    """

    w_bit: int = W_BIT
    a_bit: int = A_BIT
    # Per-layer channel override for compressed subnets (compress/)
    channels: Any = None

    @nn.compact
    def __call__(self, x, train: bool = False):
        img_size = x.shape[1:3]
        for i, (feat, ks, pool) in enumerate(ULTRANET_LAYERS):
            if self.channels is not None:
                feat = self.channels[i]
            x = DoReFaConv(feat, ks, self.w_bit, name=f"conv_{i}")(x)
            x = nn.BatchNorm(
                use_running_average=not train,
                momentum=0.9,
                epsilon=1e-5,
                name=f"bn_{i}",
            )(x)
            x = quantize_activation(x, self.a_bit)
            if pool:
                x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = DoReFaConv(
            ULTRANET_OUT_CHANNELS, 1, self.w_bit, padding="VALID",
            use_bias=True, name=f"conv_{len(ULTRANET_LAYERS)}",
        )(x)
        if train:
            _, p = yolo_decode(x, img_size)
            return p
        return yolo_decode(x, img_size)


class UltraNetInt(nn.Module):
    """Folded-BN integer UltraNet inference (the JAX artifact path).

    Consumes integer conv weights (int32 levels in ±(2^(w_bit-1)-1)) and
    per-layer (inc, bias) int tables from
    :func:`quantized_vit_tpu.quant.integer.bn_act_quantize_int`. The whole
    trunk is integer: conv accumulates int32, requantize_int maps back to
    unsigned a_bit levels — exactly the arithmetic the reference's FPGA
    headers encode (qnn_mem_process.py / quantization.py:68-89). The final
    1x1 conv dequantizes to float for the YOLO head.

    Weights enter as a dict (via ``variables['params']``):
      conv_i/kernel_int [kh, kw, cin, cout] int8-valued int32
      conv_i/inc, conv_i/bias_int [cout] int32   (i < 8)
      conv_8/kernel_int, conv_8/bias [cout] float32
    """

    w_bit: int = W_BIT
    a_bit: int = A_BIT
    in_bit_first: int = 8  # first layer consumes 8-bit input levels
    l_shift: int = 8  # ultranet_param_gen.py:20

    @nn.compact
    def __call__(self, x_levels):
        img_size = x_levels.shape[1:3]
        x = x_levels.astype(jnp.int32)
        for i, (feat, ks, pool) in enumerate(ULTRANET_LAYERS):
            in_bit = self.in_bit_first if i == 0 else self.a_bit
            k = self.param(
                f"conv_{i}_kernel_int", nn.initializers.zeros,
                (ks, ks, x.shape[-1], feat), jnp.int32,
            )
            inc = self.param(f"conv_{i}_inc", nn.initializers.zeros,
                             (feat,), jnp.int32)
            bias = self.param(f"conv_{i}_bias_int", nn.initializers.zeros,
                              (feat,), jnp.int32)
            acc = jax.lax.conv_general_dilated(
                x, k,
                window_strides=(1, 1), padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32,
            )
            x = requantize_int(
                acc, inc, bias,
                w_bit=self.w_bit, in_bit=in_bit, out_bit=self.a_bit,
                l_shift=self.l_shift,
            )
            if pool:
                x = nn.max_pool(x, (2, 2), strides=(2, 2))
        # last conv: integer weights, float bias, float output (YOLO head)
        k = self.param(
            "conv_8_kernel_int", nn.initializers.zeros,
            (1, 1, x.shape[-1], ULTRANET_OUT_CHANNELS), jnp.int32,
        )
        b = self.param("conv_8_bias", nn.initializers.zeros,
                       (ULTRANET_OUT_CHANNELS,), jnp.float32)
        acc = jax.lax.conv_general_dilated(
            x, k, window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32,
        )
        s_w = 1.0 / (2.0 ** (self.w_bit - 1) - 1.0)
        s_in = 1.0 / (2.0**self.a_bit - 1.0)
        out = acc.astype(jnp.float32) * (s_w * s_in) + b
        return yolo_decode(out, img_size)
