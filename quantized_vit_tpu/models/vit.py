"""Vision Transformer family (flax), quantization-aware via QuantConfig.

JAX re-design of the reference's timm-derived model
(QViT_with_GETA/vit_model.py:211-483), matching its architecture exactly:

- PatchEmbed: patch_size conv stride patch_size -> flatten -> optional norm
  (vit_model.py:46-103); with quantization on, the conv is a QuantConv (the
  reference swaps it via model_to_quantize_model, train.py:247-250).
- ViTAttention with a FUSED qkv projection (dim -> 3*dim, one QuantDense —
  vit_model.py:125-153); scaled dot-product, softmax, proj.
- Pre-norm Blocks with DropPath stochastic depth (vit_model.py:180-208),
  drop-path rates linearly spaced 0..drop_path_ratio (vit_model.py:272).
- cls token + learned position embeddings (vit_model.py:277-281),
  LayerNorm(eps=1e-6) everywhere (vit_model.py:242), optional tanh
  pre-logits for in21k checkpoints (vit_model.py:295-302).

LayerNorms, softmax and residuals stay float (the reference never quantizes
them — SURVEY.md §3.4); only Dense/Conv layers carry quant params.

Inputs are NHWC. ``ViTConfig`` lives in the flax-free ``configs`` module
(re-exported here). Factories mirror vit_model.py:351-483.
"""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from ..configs import QuantConfig, ViTConfig
from .layers import QuantConv, QuantDense

__all__ = ["QuantConfig", "ViTConfig", "VisionTransformer"]


class DropPath(nn.Module):
    """Stochastic depth — drop the whole residual branch per sample."""

    rate: float

    @nn.compact
    def __call__(self, x, deterministic: bool):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        rng = self.make_rng("dropout")
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = jax.random.bernoulli(rng, keep, shape)
        return jnp.where(mask, x / keep, 0.0)


class PatchEmbed(nn.Module):
    cfg: ViTConfig

    @nn.compact
    def __call__(self, x):
        p = self.cfg.patch_size
        x = QuantConv(
            features=self.cfg.embed_dim,
            kernel_size=(p, p),
            strides=(p, p),
            padding="VALID",
            config=self.cfg.quant,
            use_bias=True,
            name="proj",
        )(x)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)


class ViTAttention(nn.Module):
    cfg: ViTConfig
    num_heads: Optional[int] = None  # per-block override (compressed subnets)

    @nn.compact
    def __call__(self, x, deterministic: bool):
        c = self.cfg
        b, n, dim = x.shape
        heads = self.num_heads if self.num_heads is not None else c.num_heads
        # head_dim is set by the ORIGINAL head count — head pruning removes
        # whole heads but keeps head_dim (pruning_compression.py:296-316)
        head_dim = c.embed_dim // c.num_heads
        scale = c.qk_scale if c.qk_scale is not None else head_dim**-0.5

        qkv = QuantDense(
            features=heads * head_dim * 3, config=c.quant,
            use_bias=c.qkv_bias, name="qkv",
        )(x)
        qkv = qkv.reshape(b, n, 3, heads, head_dim)
        qkv = jnp.transpose(qkv, (2, 0, 3, 1, 4))  # [3, B, H, N, hd]
        q, k, v = qkv[0], qkv[1], qkv[2]

        # mixed-precision QAT (QuantConfig.matmul_dtype): score/AV dots in
        # bf16 with f32 accumulation; softmax stays f32
        if c.quant.enabled and c.quant.matmul_dtype is not None:
            mdt = jnp.dtype(c.quant.matmul_dtype)
            attn = jnp.einsum("bhnd,bhmd->bhnm", q.astype(mdt),
                              k.astype(mdt),
                              preferred_element_type=jnp.float32) * scale
        else:
            attn = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
        attn = jax.nn.softmax(attn, axis=-1)
        attn = nn.Dropout(rate=c.attn_drop_ratio)(attn, deterministic=deterministic)

        if c.quant.enabled and c.quant.matmul_dtype is not None:
            mdt = jnp.dtype(c.quant.matmul_dtype)
            out = jnp.einsum("bhnm,bhmd->bhnd", attn.astype(mdt),
                             v.astype(mdt),
                             preferred_element_type=jnp.float32)
        else:
            out = jnp.einsum("bhnm,bhmd->bhnd", attn, v)
        out = jnp.transpose(out, (0, 2, 1, 3)).reshape(b, n, heads * head_dim)
        out = QuantDense(features=dim, config=c.quant, name="proj")(out)
        out = nn.Dropout(rate=c.drop_ratio)(out, deterministic=deterministic)
        return out


class Mlp(nn.Module):
    cfg: ViTConfig
    hidden: Optional[int] = None  # per-block override (compressed subnets)

    @nn.compact
    def __call__(self, x, deterministic: bool):
        c = self.cfg
        hidden = (self.hidden if self.hidden is not None
                  else int(c.embed_dim * c.mlp_ratio))
        x = QuantDense(features=hidden, config=c.quant, name="fc1")(x)
        x = nn.gelu(x, approximate=False)
        x = nn.Dropout(rate=c.drop_ratio)(x, deterministic=deterministic)
        x = QuantDense(features=c.embed_dim, config=c.quant, name="fc2")(x)
        x = nn.Dropout(rate=c.drop_ratio)(x, deterministic=deterministic)
        return x


class Block(nn.Module):
    cfg: ViTConfig
    drop_path_rate: float
    index: int = 0

    @nn.compact
    def __call__(self, x, deterministic: bool):
        c = self.cfg
        h = nn.LayerNorm(epsilon=1e-6, name="norm1")(x)
        h = ViTAttention(c, num_heads=c.block_heads(self.index),
                         name="attn")(h, deterministic)
        x = x + DropPath(self.drop_path_rate, name="drop_path1")(h, deterministic)
        h = nn.LayerNorm(epsilon=1e-6, name="norm2")(x)
        h = Mlp(c, hidden=c.block_hidden(self.index), name="mlp")(h, deterministic)
        x = x + DropPath(self.drop_path_rate, name="drop_path2")(h, deterministic)
        return x


class VisionTransformer(nn.Module):
    cfg: ViTConfig

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        c = self.cfg
        b = x.shape[0]
        x = PatchEmbed(c, name="patch_embed")(x)  # [B, N, D]

        cls = self.param(
            "cls_token", nn.initializers.truncated_normal(stddev=0.02),
            (1, 1, c.embed_dim), jnp.float32,
        )
        pos = self.param(
            "pos_embed", nn.initializers.truncated_normal(stddev=0.02),
            (1, c.num_tokens, c.embed_dim), jnp.float32,
        )
        x = jnp.concatenate([jnp.broadcast_to(cls, (b, 1, c.embed_dim)), x], axis=1)
        x = x + pos
        x = nn.Dropout(rate=c.drop_ratio)(x, deterministic=deterministic)

        import numpy as _np

        # stochastic depth decay rule (vit_model.py:272); numpy so the rates
        # stay static under tracing
        dpr = [float(r) for r in _np.linspace(0.0, c.drop_path_ratio, c.depth)]
        for i in range(c.depth):
            x = Block(c, dpr[i], index=i, name=f"blocks_{i}")(x, deterministic)

        x = nn.LayerNorm(epsilon=1e-6, name="norm")(x)
        x = x[:, 0]  # cls token

        if c.representation_size is not None:
            x = nn.Dense(c.representation_size, name="pre_logits")(x)
            x = jnp.tanh(x)

        if c.num_classes > 0:
            x = QuantDense(features=c.num_classes, config=c.quant, name="head")(x)
        return x


# ---------------------------------------------------------------------------
# Factories (vit_model.py:351-483)
# ---------------------------------------------------------------------------


def _make(img, patch, dim, depth, heads, rep, num_classes, quant):
    return VisionTransformer(
        ViTConfig(
            img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
            num_heads=heads, representation_size=rep, num_classes=num_classes,
            quant=quant,
        )
    )


def vit_base_patch16_224(num_classes=1000, quant=QuantConfig.off()):
    return _make(224, 16, 768, 12, 12, None, num_classes, quant)


def vit_base_patch16_224_in21k(num_classes=21843, has_logits=True,
                               quant=QuantConfig.off()):
    return _make(224, 16, 768, 12, 12, 768 if has_logits else None,
                 num_classes, quant)


def vit_base_patch32_224(num_classes=1000, quant=QuantConfig.off()):
    return _make(224, 32, 768, 12, 12, None, num_classes, quant)


def vit_base_patch32_224_in21k(num_classes=21843, has_logits=True,
                               quant=QuantConfig.off()):
    return _make(224, 32, 768, 12, 12, 768 if has_logits else None,
                 num_classes, quant)


def vit_large_patch16_224(num_classes=1000, quant=QuantConfig.off()):
    return _make(224, 16, 1024, 24, 16, None, num_classes, quant)


def vit_large_patch16_224_in21k(num_classes=21843, has_logits=True,
                                quant=QuantConfig.off()):
    return _make(224, 16, 1024, 24, 16, 1024 if has_logits else None,
                 num_classes, quant)


def vit_large_patch32_224_in21k(num_classes=21843, has_logits=True,
                                quant=QuantConfig.off()):
    return _make(224, 32, 1024, 24, 16, 1024 if has_logits else None,
                 num_classes, quant)


def vit_huge_patch14_224_in21k(num_classes=21843, has_logits=True,
                               quant=QuantConfig.off()):
    return _make(224, 14, 1280, 32, 16, 1280 if has_logits else None,
                 num_classes, quant)
