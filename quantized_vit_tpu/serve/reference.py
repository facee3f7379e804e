"""Float32 reference of the INT4 ViT serving forward.

An independent, plain implementation of what
:func:`~.vit_int4.vit_int4_forward` computes, used to check the integer
path on any device. It shares no code with ``ops/``: every quantized
layer's weight is dequantized to float32 (levels x d_w, where the
artifact's fused scale is d_w * d_a), its input is fake-quantized with the
LSFQ forward of ``quant/lsfq.py``, and LayerNorm, softmax attention and
GELU (exact erf) run in float32 in the token order of the flax model (cls
first, no padding). Every dot runs at
``Precision.HIGHEST``, so a GPU does not round it to TF32.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp

from ..configs import ViTConfig
from ..quant.lsfq import lsfq_linear, lsfq_nonlinear
from ..quant.packing import unpack_int4

_HI = jax.lax.Precision.HIGHEST


def _dequant_weight(e) -> jax.Array:
    """Float32 weight d_w * levels [K, N] of one artifact entry."""
    lv = unpack_int4(e.w, axis=0) if e.fmt == "int4" else e.w
    d_w = jnp.asarray(e.scale, jnp.float32) / jnp.asarray(e.act["d"],
                                                          jnp.float32)
    return lv.astype(jnp.float32) * d_w


def _fake_quant_act(x, e) -> jax.Array:
    """LSFQ activation fake-quant of a layer's input (values d_a * level)."""
    act = {k: jnp.asarray(v, jnp.float32) for k, v in e.act.items()}
    clip = jnp.asarray([-2.0, 2.0], jnp.float32)  # forward ignores it
    q_s = jnp.float32(0.0)
    if e.act_pow:
        return lsfq_nonlinear(x, act["d"], act["q_m"], act["t"], clip, q_s)
    return lsfq_linear(x, act["d"], act["q_m"], clip, q_s)


def _qdense(x, e):
    y = jnp.dot(_fake_quant_act(x, e), _dequant_weight(e), precision=_HI)
    return y if e.bias is None else y + jnp.asarray(e.bias, jnp.float32)


def _layernorm(x, p, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return (x - mu) / jnp.sqrt(var + eps) * p["scale"] + p["bias"]


def _attention(x, blk, hd: int, sm_scale: float):
    b, n, _ = x.shape
    qkv = _qdense(x, blk["qkv"])
    heads = qkv.shape[-1] // (3 * hd)
    qkv = qkv.reshape(b, n, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    s = jnp.einsum("bnhd,bmhd->bhnm", q, k, precision=_HI) * sm_scale
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhnm,bmhd->bnhd", p, v, precision=_HI)
    return _qdense(o.reshape(b, n, heads * hd), blk["proj"])


def reference_embed(art: Dict[str, Any], images, cfg: ViTConfig,
                    images_layout: str = "nhwc"):
    """Patch embedding, cls token and position embedding: [B, N, D] f32,
    cls first. images as for :func:`vit_reference_forward`."""
    p = cfg.patch_size
    b = images.shape[0]
    x = jnp.asarray(images, jnp.float32)
    if images_layout == "nhwc":
        g = cfg.img_size // p
        x = x.reshape(b, g, p, g, p, cfg.in_channels)
        x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
    x = _qdense(x, art["patch_embed"])                     # [B, N-1, D]
    cls = jnp.broadcast_to(jnp.asarray(art["cls_token"], jnp.float32),
                           (b, 1, x.shape[-1]))
    return jnp.concatenate([cls, x], axis=1) + art["pos_embed"]


def reference_attn(x, blk: Dict[str, Any], cfg: ViTConfig):
    """x + attention(LN1(x)) on the [B, N, D] f32 residual stream."""
    hd = cfg.embed_dim // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5
    return x + _attention(_layernorm(x, blk["norm1"]), blk, hd, sm_scale)


def reference_mlp(x, blk: Dict[str, Any]):
    """x + fc2(GELU(fc1(LN2(x)))) on the [B, N, D] f32 residual stream."""
    h = _qdense(_layernorm(x, blk["norm2"]), blk["fc1"])
    return x + _qdense(jax.nn.gelu(h, approximate=False), blk["fc2"])


def reference_head(x, art: Dict[str, Any]):
    """Final LayerNorm on the cls token of [B, N, D], optional tanh
    pre-logits, classifier: f32 logits."""
    x = _layernorm(x, art["norm"])[:, 0]
    if "pre_logits" in art:
        x = jnp.tanh(jnp.dot(x, art["pre_logits"]["kernel"], precision=_HI)
                     + art["pre_logits"]["bias"])
    if "head" in art:
        x = _qdense(x, art["head"])
    return x


@functools.partial(jax.jit, static_argnames=("cfg", "images_layout"))
def vit_reference_forward(art: Dict[str, Any], images, cfg: ViTConfig,
                          images_layout: str = "nhwc"):
    """Float32 logits of a serving artifact. images: [B, H, W, C] float, or
    [B, (H/P)*(W/P), P*P*C] with ``images_layout='patches'``."""
    x = reference_embed(art, images, cfg, images_layout)
    for blk in art["blocks"]:
        x = reference_mlp(reference_attn(x, blk, cfg), blk)
    return reference_head(x, art)
