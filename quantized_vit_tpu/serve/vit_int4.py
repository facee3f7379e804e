"""ViT W4A4 serving path: exported integer artifacts run as int8 XLA dots.

This replaces the reference's float fake-quant inference
(quant_layers.py:575-587 forward) with real integer matmuls:

- :func:`export_vit_int4` converts a trained fake-quant params pytree into a
  serving artifact: per quantized layer, weight integer levels packed int4
  (or int8 when the trained bit width exceeds 4 — GETA produces mixed
  precision), the fused dequant scale ``d_w * d_a``, the float bias, and the
  activation quantizer constants (d_a, q_m_a, t_a, top level).
- :func:`vit_int4_forward` runs the ViT with every Dense/Conv as an
  int8 x int4/int8 -> int32 dot with its quantize prologue and dequant
  epilogue (ops/fused.py). The patch-embed 16x16/s16 conv is exactly a
  [B*196, p*p*3] x [p*p*3, D] gemm (vit_model.py:78,100), so it uses the
  same op. LayerNorm/softmax/GELU/residuals stay float, matching the
  reference's quantization surface (SURVEY.md §3.4).

Numerics: identical to the fake-quant forward because LSFQ quantized values
are integer multiples of d — sum((d_w i_w)(d_a i_a)) = d_w d_a sum(i_w i_a)
exactly (see quant/lsfq.py). Tests assert parity against the float model
and against the independent float reference in serve/reference.py.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("w", "scale", "bias", "act"),
    meta_fields=("fmt", "act_pow", "top"),
)
@dataclasses.dataclass
class QLayerArtifact:
    """One quantized layer's serving artifact. ``fmt`` ('int4'/'int8'),
    ``act_pow`` (whether the layer's activation t != 1, i.e. the power map
    must run) and ``top`` (the activation clip level, a per-layer export-
    time constant) are pytree metadata so they stay static under jit and
    the compiled program branches on none of them."""

    w: jax.Array          # packed int4 [K/2, N] or int8 [K, N]
    scale: jax.Array      # d_w * d_a
    bias: Any             # [N] f32 or None
    act: Dict[str, jax.Array]  # activation quantizer constants (d, q_m, t)
    fmt: str
    act_pow: bool = True
    top: int = 127

from ..configs import ViTConfig
from ..ops import attention_qkv_xla, fused_mlp_xla, fused_quant_matmul_xla
from ..ops.fused import _quantize_f32
from ..quant.lsfq import lsfq_levels, lsfq_top_level
from ..quant.packing import pack_int4


def _export_layer(layer_params: Dict[str, Any], pack_weights: bool = True):
    """One QuantDense/QuantConv -> serving artifact entry.

    ``pack_weights``: store 4-bit levels nibble-packed ([K/2, N], half the
    weight bytes) vs unpacked int8 ([K, N]). The serving forward unpacks
    packed weights to int8 before the dot; which format is faster on a
    given card is a benchmark question, not settled here.
    """
    kernel = layer_params["kernel"]
    if kernel.ndim == 4:  # conv HWIO -> [H*W*I, O] gemm form
        h, w, i, o = kernel.shape
        kernel = kernel.reshape(h * w * i, o)
    d_w = layer_params["d_quant_wt"]
    qm_w = layer_params["q_m_wt"]
    t_w = layer_params.get("t_quant_wt", jnp.ones_like(d_w))

    w_lv = lsfq_levels(kernel, d_w, qm_w, t_w)
    top_w = int(lsfq_top_level(d_w, qm_w, t_w)[0])

    d_a = layer_params["d_quant_act"]
    qm_a = layer_params["q_m_act"]
    t_a = layer_params.get("t_quant_act", jnp.ones_like(d_a))
    top_a = lsfq_top_level(d_a, qm_a, t_a)[0]

    # Layers trained above 8 bits (export before GETA's projection settles)
    # can't ride the int8 dot at their learned step size — level
    # CLIPPING would corrupt values, so instead REQUANTIZE properly to
    # 8 bits: widen d to d(8 bits) and recompute the levels. This is a
    # sound 8-bit quantization of the same float tensor (numerics change
    # by at most d8/2 per value), flagged with a warning.
    if top_w > 127 or float(top_a) > 127:
        import warnings

        from ..quant.bitwidth import d_for_bits

        warnings.warn(
            f"layer trained above 8 bits (weight top {top_w}, act top "
            f"{float(top_a):.0f}); requantizing to 8 bits for the INT8 "
            "serving path", stacklevel=2)
        if top_w > 127:
            d_w = jnp.broadcast_to(d_for_bits(8.0, qm_w, t_w), d_w.shape)
            w_lv = lsfq_levels(kernel, d_w, qm_w, t_w)
            top_w = int(lsfq_top_level(d_w, qm_w, t_w)[0])
        if float(top_a) > 127:
            d_a = jnp.broadcast_to(d_for_bits(8.0, qm_a, t_a), d_a.shape)
            top_a = lsfq_top_level(d_a, qm_a, t_a)[0]
    act = {"d": d_a[0], "q_m": qm_a[0], "t": t_a[0]}
    top = int(min(float(top_a), 127.0))
    act_pow = bool(abs(float(t_a[0]) - 1.0) > 1e-6)
    k = w_lv.shape[0]
    if pack_weights and top_w <= 7 and k % 2 == 0:
        return QLayerArtifact(
            w=pack_int4(jnp.clip(w_lv, -8, 7).astype(jnp.int8), axis=0),
            scale=(d_w * d_a)[0], bias=layer_params.get("bias"),
            act=act, fmt="int4", act_pow=act_pow, top=top,
        )
    return QLayerArtifact(
        w=jnp.clip(w_lv, -127, 127).astype(jnp.int8),
        scale=(d_w * d_a)[0], bias=layer_params.get("bias"),
        act=act, fmt="int8", act_pow=act_pow, top=top,
    )


def export_vit_int4(cfg: ViTConfig, params: Dict[str, Any],
                    pack_weights: bool = True) -> Dict[str, Any]:
    """Trained fake-quant ViT params -> integer serving artifact pytree.

    ``fmt`` per layer is a static string ('int4'/'int8'); everything else is
    arrays, so the artifact passes straight through jit as a pytree.
    ``pack_weights=False`` stores 4-bit levels unpacked int8 (see
    :func:`_export_layer`).
    """
    art: Dict[str, Any] = {}
    art["patch_embed"] = _export_layer(params["patch_embed"]["proj"],
                                       pack_weights)
    art["cls_token"] = params["cls_token"]
    art["pos_embed"] = params["pos_embed"]
    art["blocks"] = []
    for i in range(cfg.depth):
        b = params[f"blocks_{i}"]
        art["blocks"].append({
            "norm1": b["norm1"],
            "qkv": _export_layer(b["attn"]["qkv"], pack_weights),
            "proj": _export_layer(b["attn"]["proj"], pack_weights),
            "norm2": b["norm2"],
            "fc1": _export_layer(b["mlp"]["fc1"], pack_weights),
            "fc2": _export_layer(b["mlp"]["fc2"], pack_weights),
        })
    art["norm"] = params["norm"]
    if cfg.representation_size is not None:
        art["pre_logits"] = {k: v for k, v in params["pre_logits"].items()}
    if cfg.num_classes > 0:
        art["head"] = _export_layer(params["head"], pack_weights)
    return art


def _qmatmul(x2d, entry: QLayerArtifact, float_dtype=jnp.float32, **kw):
    """Quantized matmul with fused prologue/epilogue (see ops/fused.py)."""
    kw.setdefault("prologue", "quant")
    if kw["prologue"] is not None:
        kw.setdefault("act_d", entry.act["d"])
        kw.setdefault("act_t", entry.act["t"])
        kw.setdefault("act_top", entry.top)
        kw.setdefault("act_pow", entry.act_pow)
    return fused_quant_matmul_xla(x2d, entry.w, entry.scale, entry.bias,
                                  fmt=entry.fmt, out_dtype=float_dtype, **kw)


def _layernorm(x, p, eps=1e-6):
    dt = x.dtype
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mu), axis=-1, keepdims=True)
    return ((x32 - mu) * jax.lax.rsqrt(var + eps) * p["scale"]
            + p["bias"]).astype(dt)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _embed_tokens(art, images, cfg: ViTConfig, float_dtype,
                  images_layout: str, n_align: int = 16):
    """Patch-embed + pos-embed + cls + pad: images -> [B*n_pad, D] rows.

    Shared by the single-device forward and the shard_map TP/FSDP forwards
    (serve/vit_tp.py, serve/vit_fsdp.py), which run it per device on their
    local images. Returns (x2d, n_pad, dim). Token layout: patches first,
    cls LAST real row, pad rows above — attention is token-permutation-
    invariant and masks the pad keys. ``n_align``: token-pad granularity
    (16: 197 -> 208 rows per image)."""
    b = images.shape[0]
    p = cfg.patch_size
    g = cfg.img_size // p

    pe = art["patch_embed"]
    if images_layout == "patches":
        acc32 = _qmatmul(
            images.reshape(b * g * g, p * p * cfg.in_channels), pe,
            jnp.float32, prologue="quant", epilogue=None,
        )
        dim = acc32.shape[1]
        acc = acc32.reshape(b, g, g, dim)
    else:
        # bf16 LEVEL conv: quantize the image to integer levels
        # elementwise, then XLA's strided conv on bf16 levels with f32
        # accumulation. Exact vs the int gemm form because levels (<=127)
        # and their products are exact in bf16 and the accumulator stays
        # below 2^24 (768 * top_w * top_a <= 1.24e7).
        if pe.fmt == "int4":
            from ..quant.packing import unpack_int4

            w_lv = unpack_int4(pe.w, axis=0)
        else:
            w_lv = pe.w
        dim = w_lv.shape[1]
        w_conv = w_lv.reshape(p, p, cfg.in_channels, dim).astype(jnp.bfloat16)
        img_lv = _quantize_f32(images, pe.act["d"], pe.act["t"], pe.top,
                               pe.act_pow).astype(jnp.bfloat16)
        acc = jax.lax.conv_general_dilated(
            img_lv, w_conv, window_strides=(p, p), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)

    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, n_align)

    pos = art["pos_embed"].astype(jnp.float32).reshape(n_real, dim)
    cls_row = art["cls_token"].astype(jnp.float32).reshape(dim) + pos[0]
    pos_patch = pos[1:]
    pe_scale = jnp.float32(1.0) if images_layout == "patches" else pe.scale
    if pe.bias is not None and images_layout != "patches":
        pos_patch = pos_patch + pe.bias
    acc = acc.reshape(b, g * g, dim)
    body = acc * jnp.asarray(pe_scale, jnp.float32) + pos_patch
    x = jnp.concatenate(
        [body, jnp.broadcast_to(cls_row, (b, 1, dim))], axis=1
    ).astype(float_dtype)
    if n_pad != n_real:
        x = jnp.pad(x, ((0, 0), (0, n_pad - n_real), (0, 0)))
    return x.reshape(b * n_pad, dim), n_pad, dim


def _attn_branch(x2d, blk, *, b: int, n_pad: int, n_real: int, hd: int,
                 sm_scale: float, float_dtype, int_attention: bool):
    """x + attention(LN1(x)) on the [B*n_pad, D] residual rows."""
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    # heads may differ per block in GETA-compressed subnets; the qkv
    # width encodes it (N = 3 * heads_i * hd)
    heads_i = qkv_e.w.shape[1] // (3 * hd)
    qkv = _qmatmul(
        x2d, qkv_e, float_dtype, prologue="ln_quant",
        ln_scale=blk["norm1"]["scale"], ln_bias=blk["norm1"]["bias"],
    )
    alv = attention_qkv_xla(
        qkv.reshape(b, n_pad, 3 * heads_i * hd),
        heads=heads_i, sm_scale=sm_scale, n_valid=n_real,
        out_d=proj_e.act["d"], out_t=proj_e.act["t"],
        out_top=proj_e.top, out_pow=proj_e.act_pow,
        int_attention=int_attention,
    )
    return _qmatmul(
        alv.reshape(b * n_pad, heads_i * hd), proj_e, float_dtype,
        prologue=None, epilogue="residual", residual=x2d,
    )


def _mlp_branch(x2d, blk, float_dtype):
    """x + fc2(GELU(fc1(LN2(x)))) on the [B*n_pad, D] residual rows."""
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    return fused_mlp_xla(
        x2d, fc1_e.w, fc1_e.scale, fc1_e.bias,
        fc2_e.w, fc2_e.scale, fc2_e.bias,
        ln_scale=blk["norm2"]["scale"], ln_bias=blk["norm2"]["bias"],
        act_d=fc1_e.act["d"], act_t=fc1_e.act["t"],
        act_top=fc1_e.top, act_pow=fc1_e.act_pow,
        hid_d=fc2_e.act["d"], hid_t=fc2_e.act["t"],
        hid_top=fc2_e.top, hid_pow=fc2_e.act_pow,
        fmt=fc1_e.fmt, fmt2=fc2_e.fmt, out_dtype=float_dtype,
    )


def _vit_block(x2d, blk, *, b: int, n_pad: int, n_real: int, dim: int,
               hd: int, sm_scale: float, float_dtype, int_attention: bool):
    """One transformer block of the serving forward (attention branch +
    MLP branch). Shared by the single-device forward and the FSDP
    weight-gather forward (serve/vit_fsdp.py), which runs it per device on
    gathered weights."""
    with jax.named_scope("attn"):
        x2d = _attn_branch(x2d, blk, b=b, n_pad=n_pad, n_real=n_real, hd=hd,
                           sm_scale=sm_scale, float_dtype=float_dtype,
                           int_attention=int_attention)
    with jax.named_scope("mlp"):
        x2d = _mlp_branch(x2d, blk, float_dtype)
    return x2d


def _head(x, art):
    """Final LayerNorm on the cls rows [B, D], optional tanh pre-logits,
    quantized classifier head. Returns f32."""
    x = _layernorm(x, art["norm"]).astype(jnp.float32)
    if "pre_logits" in art:
        x = jnp.tanh(jnp.dot(x, art["pre_logits"]["kernel"],
                             precision=jax.lax.Precision.HIGHEST)
                     + art["pre_logits"]["bias"])
    if "head" in art:
        x = _qmatmul(x, art["head"], jnp.float32)
    return x


def _blocks_uniform(blocks) -> bool:
    """True when every block shares geometry and static quantizer metadata
    — the precondition for scanning one traced block body over stacked
    weights (GETA-compressed subnets with per-block head counts, or
    mixed-precision exports with per-layer tops, fall back to unrolling)."""
    def sig(b):
        return tuple(
            (k, b[k].fmt, b[k].act_pow, b[k].top, b[k].bias is not None,
             tuple(b[k].w.shape))
            for k in ("qkv", "proj", "fc1", "fc2"))
    s0 = sig(blocks[0])
    return all(sig(b) == s0 for b in blocks[1:])


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "float_dtype", "int_attention",
                     "images_layout", "scan_blocks", "n_align",
                     "input_scale"),
)
def vit_int4_forward(art, images, cfg: ViTConfig,
                     float_dtype=jnp.float32, int_attention: bool = False,
                     images_layout: str = "nhwc",
                     scan_blocks: bool = False,
                     n_align: int = 16,
                     input_scale: float | None = None):
    """Quantized ViT forward on integer weights. images: [B, H, W, 3] f32,
    or — with ``images_layout='patches'`` — the host-patchified
    [B, (H/P)*(W/P), P*P*3] layout from utils.native_prep.patchify_batch,
    whose patch embed is an ordinary K=P*P*3 quantized matmul.

    Per transformer block (ops/fused.py, ops/attention.py):

      qkv  = matmul(x, prologue=LN1+quant)                float [M, 3D]
      alv  = attention(qkv), output quantized to the
             proj layer's int8 levels                     int8 [M, D]
      x    = matmul(alv, epilogue=residual+x)             float [M, D]
      hlv  = matmul(x, prologue=LN2+quant,
             epilogue=GELU+quant to fc2's levels)         int8 [M, Hid]
      x    = matmul(hlv, epilogue=residual+x)             float [M, D]

    Tokens are padded once (197 -> multiple of ``n_align``) right after
    pos-embed; attention masks the padded keys.

    ``float_dtype`` sets the residual-stream dtype. bf16 is the serving
    configuration; f32 is the strict-parity configuration the tests compare
    against the fake-quant model (its f32 dots run at HIGHEST precision).
    Level math is always f32. ``input_scale``: images arrive as integers
    (uint8 pixels, 4x fewer host->device bytes than f32) and are cast and
    scaled on device. ``scan_blocks``: one traced block body under
    ``lax.scan`` over stacked weights (smaller program, faster compile;
    needs uniform blocks, else the loop unrolls). Pass the artifact as a
    jit ARGUMENT, never a closure constant — a closure artifact is inlined
    into the program as literals.
    """
    b = images.shape[0]
    if input_scale is not None:
        images = images.astype(jnp.float32) * jnp.float32(input_scale)

    with jax.named_scope("embed"):
        x2d, n_pad, dim = _embed_tokens(art, images, cfg, float_dtype,
                                        images_layout, n_align=n_align)
    n_real = cfg.num_tokens

    hd = dim // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5

    blocks = art["blocks"]
    common = dict(b=b, n_pad=n_pad, n_real=n_real, dim=dim, hd=hd,
                  sm_scale=sm_scale, float_dtype=float_dtype,
                  int_attention=int_attention)
    if scan_blocks and len(blocks) > 1 and _blocks_uniform(blocks):
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *blocks)

        def body(carry, blk):
            return _vit_block(carry, blk, **common), None

        x2d, _ = jax.lax.scan(body, x2d, stacked)
    else:
        for blk in blocks:
            x2d = _vit_block(x2d, blk, **common)

    with jax.named_scope("head"):
        # cls row is the last real row
        return _head(x2d.reshape(b, n_pad, dim)[:, n_real - 1], art)


def random_vit_int4_artifact(cfg: ViTConfig, seed: int = 0,
                             pack_weights: bool = True):
    """Random serving artifact with realistic scales, made from ``seed``
    (bench and smoke helper — avoids the flax init of an 86M-param
    model)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)

    def qlayer(k, n, with_bias=True):
        w = rng.integers(-7, 8, (k, n)).astype(np.int8)
        return QLayerArtifact(
            w=pack_int4(jnp.array(w), axis=0) if pack_weights
            else jnp.array(w),
            scale=jnp.float32(1e-3),
            bias=jnp.array(rng.standard_normal(n).astype(np.float32) * 1e-2)
            if with_bias else None,
            act={"d": jnp.float32(0.05), "q_m": jnp.float32(0.35),
                 "t": jnp.float32(1.0)},
            fmt="int4" if pack_weights else "int8", act_pow=False, top=7,
        )

    def ln(n):
        return {"scale": jnp.ones((n,), jnp.float32),
                "bias": jnp.zeros((n,), jnp.float32)}

    art = {
        "patch_embed": qlayer(cfg.patch_size**2 * cfg.in_channels, d),
        "cls_token": jnp.array(
            rng.standard_normal((1, 1, d)).astype(np.float32) * 0.02),
        "pos_embed": jnp.array(
            rng.standard_normal((1, cfg.num_tokens, d)).astype(np.float32) * 0.02),
        "blocks": [
            {
                "norm1": ln(d),
                "qkv": qlayer(d, 3 * d),
                "proj": qlayer(d, d),
                "norm2": ln(d),
                "fc1": qlayer(d, hidden),
                "fc2": qlayer(hidden, d),
            }
            for _ in range(cfg.depth)
        ],
        "norm": ln(d),
    }
    if cfg.num_classes > 0:
        art["head"] = qlayer(d, cfg.num_classes)
    return art
