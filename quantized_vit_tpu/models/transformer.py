"""Generic sequence Transformer encoder with SEPARATE q/k/v projections.

The reference's OTO operator library supports attention modules whose q, k,
v are three independent Linear layers — BertAttention / LlamaAttention /
PhiAttention (only_train_once/operation/operator.py:1012-1130, 1253-1290) —
pruned at HEAD granularity via BaseMultiHeadAttentionOTO (operator.py:810-975
with head-idx -> dim-idx expansion at :920-950), alongside EmbeddingOTO
(operator.py:677-706). This model family exercises that coverage in the
JAX framework: a text/sequence encoder whose attention uses three
QuantDense projections, with a token embedding table and learned position
embeddings, so the pruning graph must handle

- per-head groups spanning the three separate projections at once,
- the out-proj in-dim following kept heads (head expansion),
- an embedding whose feature dim rides the residual stream.

The flax embedding param is [vocab, features] with the feature axis LAST, so
the residual-stream membership is the standard Transform.OUT — the torch
version needed TRANSPOSE (operator.py:677-706) only because torch stores the
same table with the pruned axis second.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from .layers import QuantConfig, QuantDense


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    max_len: int = 128
    num_classes: int = 2
    embed_dim: int = 256
    depth: int = 4
    num_heads: int = 4
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    causal: bool = False           # decoder-style masking (Llama-like)
    # grouped-query attention: q has num_heads, k/v have num_kv_heads and
    # each kv head serves num_heads/num_kv_heads query heads (Llama-2/3
    # style). None = standard MHA. Pruning granularity becomes the KV head:
    # dropping one removes its whole query group.
    num_kv_heads: Optional[int] = None
    rope: bool = False             # rotary position embeddings on q/k
    # "gelu": fc1 -> GELU -> fc2 (ViT/Bert). "swiglu": silu(gate(x)) *
    # up(x) -> fc2 (Llama) — gate and up share the hidden dim, so one
    # pruning decision spans BOTH kernels' out rows (plus fc2's in-dim).
    mlp_type: str = "gelu"
    drop_ratio: float = 0.0
    quant: QuantConfig = QuantConfig.off()
    # Per-block overrides for compressed subnets (compress/)
    heads_per_block: Optional[Tuple[int, ...]] = None
    hidden_per_block: Optional[Tuple[int, ...]] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def q_per_kv(self) -> int:
        if self.num_heads % self.kv_heads:
            raise ValueError("num_heads must divide by num_kv_heads")
        return self.num_heads // self.kv_heads

    def block_heads(self, i: int) -> int:
        return (self.heads_per_block[i] if self.heads_per_block is not None
                else self.num_heads)

    def block_hidden(self, i: int) -> int:
        return (self.hidden_per_block[i] if self.hidden_per_block is not None
                else int(self.embed_dim * self.mlp_ratio))


def rope_rotate(x, positions, base: float = 10000.0):
    """Rotary position embedding (Llama-style rotate-half) on [..., N, H, hd].

    Applied per head to q/k before the score matmul; elementwise within a
    head, so head-granular pruning passes through unchanged."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    ang = positions[:, None].astype(jnp.float32) * freqs[None, :]  # [N, hd/2]
    cos = jnp.cos(ang)[None, :, None, :]
    sin = jnp.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1
    ).astype(x.dtype)


class SeparateQKVAttention(nn.Module):
    """Multi-head attention with three independent projections (Bert-style),
    optional grouped-query attention and RoPE (Llama-style).

    Head pruning removes whole heads but keeps head_dim, exactly like the
    reference's BaseMultiHeadAttentionOTO prune_mode='num_head'
    (operator.py:896-950); under GQA the prunable unit is the KV head with
    its whole query group."""

    cfg: TransformerConfig
    num_heads: Optional[int] = None  # per-block override (compressed subnets)

    @nn.compact
    def __call__(self, x, mask, deterministic: bool):
        c = self.cfg
        b, n, dim = x.shape
        heads = self.num_heads if self.num_heads is not None else c.num_heads
        head_dim = c.embed_dim // c.num_heads  # original head_dim survives
        g = c.q_per_kv
        kv_heads = heads // g
        scale = head_dim**-0.5

        def proj(name, nh):
            y = QuantDense(features=nh * head_dim, config=c.quant,
                           use_bias=c.qkv_bias, name=name)(x)
            return y.reshape(b, n, nh, head_dim)

        q = proj("q", heads)
        k = proj("k", kv_heads)
        v = proj("v", kv_heads)
        if c.rope:
            pos = jnp.arange(n)
            q = rope_rotate(q, pos)
            k = rope_rotate(k, pos)
        # group query heads onto their kv head: [B, N, KV, G, hd]
        q = q.reshape(b, n, kv_heads, g, head_dim)
        attn = jnp.einsum("bnkgd,bmkd->bkgnm", q, k) * scale
        if mask is not None:
            attn = jnp.where(mask[:, :, None], attn, -1e30)
        if c.causal:
            causal = jnp.tril(jnp.ones((n, n), bool))
            attn = jnp.where(causal[None, None, None], attn, -1e30)
        attn = jax.nn.softmax(attn, axis=-1)
        out = jnp.einsum("bkgnm,bmkd->bnkgd", attn, v)
        out = out.reshape(b, n, heads * head_dim)
        out = QuantDense(features=dim, config=c.quant, name="proj")(out)
        return nn.Dropout(rate=c.drop_ratio)(out, deterministic=deterministic)


class TransformerBlock(nn.Module):
    cfg: TransformerConfig
    num_heads: Optional[int] = None
    hidden: Optional[int] = None

    @nn.compact
    def __call__(self, x, mask, deterministic: bool):
        c = self.cfg
        hidden = (self.hidden if self.hidden is not None
                  else int(c.embed_dim * c.mlp_ratio))
        y = nn.LayerNorm(epsilon=1e-6, name="norm1")(x)
        x = x + SeparateQKVAttention(c, num_heads=self.num_heads,
                                     name="attn")(y, mask, deterministic)
        y = nn.LayerNorm(epsilon=1e-6, name="norm2")(x)
        if c.mlp_type == "swiglu":
            gate = QuantDense(features=hidden, config=c.quant,
                              use_bias=False, name="gate")(y)
            up = QuantDense(features=hidden, config=c.quant,
                            use_bias=False, name="fc1")(y)
            y = nn.silu(gate) * up
        else:
            y = QuantDense(features=hidden, config=c.quant, name="fc1")(y)
            y = nn.gelu(y, approximate=False)
        y = QuantDense(features=c.embed_dim, config=c.quant, name="fc2")(y)
        y = nn.Dropout(rate=c.drop_ratio)(y, deterministic=deterministic)
        return x + y


class TransformerEncoder(nn.Module):
    """Pre-norm encoder: token embedding + learned positions, ``depth``
    blocks, mean-pooled classifier head (masked mean when an attention mask
    is given)."""

    cfg: TransformerConfig

    @nn.compact
    def __call__(self, tokens, attn_mask=None, deterministic: bool = True):
        c = self.cfg
        b, n = tokens.shape
        x = nn.Embed(num_embeddings=c.vocab_size, features=c.embed_dim,
                     name="embed")(tokens)
        pos = self.param("pos_embed", nn.initializers.normal(0.02),
                         (1, c.max_len, c.embed_dim))
        x = x + pos[:, :n]
        x = nn.Dropout(rate=c.drop_ratio)(x, deterministic=deterministic)

        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :].astype(bool)  # [B,1,1,N] keys
        for i in range(c.depth):
            x = TransformerBlock(
                c, num_heads=c.block_heads(i), hidden=c.block_hidden(i),
                name=f"blocks_{i}")(x, mask, deterministic)
        x = nn.LayerNorm(epsilon=1e-6, name="norm")(x)

        if attn_mask is not None:
            w = attn_mask.astype(x.dtype)[..., None]
            pooled = jnp.sum(x * w, axis=1) / jnp.maximum(
                jnp.sum(w, axis=1), 1.0)
        else:
            pooled = jnp.mean(x, axis=1)
        if c.num_classes > 0:
            pooled = QuantDense(features=c.num_classes, config=c.quant,
                                name="head")(pooled)
        return pooled


def transformer_encoder_tiny(num_classes=2, quant=QuantConfig.off()):
    return TransformerEncoder(TransformerConfig(
        vocab_size=1000, max_len=64, embed_dim=64, depth=2, num_heads=2,
        num_classes=num_classes, quant=quant))


def transformer_encoder_base(num_classes=2, quant=QuantConfig.off()):
    """BERT-base geometry: 12 layers, dim 768, 12 heads."""
    return TransformerEncoder(TransformerConfig(
        vocab_size=30522, max_len=512, embed_dim=768, depth=12, num_heads=12,
        num_classes=num_classes, quant=quant))
