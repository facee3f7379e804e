"""Quantized flax layers: the JAX counterpart of the reference's
QuantizeLinear/QuantizeConv2d module surgery.

Reference semantics (quant_layers.py:303-590):
- each quantized layer owns learnable scalars ``d_quant_wt``, ``q_m_wt``
  (+ ``t_quant_wt`` for the nonlinear quantizer), and an ``_act`` trio in
  WEIGHT_AND_ACTIVATION mode;
- forward = quantize(weight) [+ quantize(input)] then the dense/conv op;
- quant params are initialized from the float weights *after* module
  creation: q_m = max|W|, d = q_m / (2^(bits-1) - 1)
  (quant_layers.py:413-440). Here that is :func:`init_quant_params_tree`,
  a pure pytree->pytree function applied after ``model.init`` — the
  functional JAX equivalent of ``model_to_quantize_model``
  (quant_model.py:15-82).

Instead of swapping module classes, quantization is a config: every model in
``models/`` takes a :class:`QuantConfig`; ``quantize=False`` (default
``QuantConfig.off()``) makes the layers exact ``nn.Dense``/``nn.Conv``
equivalents (the FP32 baseline path, BASELINE.json config 3).
"""

from __future__ import annotations

from typing import Any, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from ..configs import QuantConfig
from ..quant.lsfq import lsfq_linear, lsfq_nonlinear, dge

QUANT_PARAM_NAMES = (
    "d_quant_wt", "q_m_wt", "t_quant_wt",
    "d_quant_act", "q_m_act", "t_quant_act",
)


def _mm_cast(config, x, kernel):
    """Mixed-precision dot operands (QuantConfig.matmul_dtype): cast the
    two operands. Returns (x, kernel, mixed); callers set
    preferred_element_type=f32 ONLY when mixed, so the pure-bf16
    unquantized baseline keeps its bf16-in/bf16-out dots."""
    if config.enabled and config.matmul_dtype is not None:
        dt = jnp.dtype(config.matmul_dtype)
        return x.astype(dt), kernel.astype(dt), True
    return x, kernel, False


class _QuantParamsMixin:
    """Shared quant-param declaration + quantize dispatch for Dense/Conv."""

    def _declare_quant_params(self, suffix: str):
        d = self.param(f"d_quant_{suffix}", nn.initializers.ones, (1,),
                       jnp.float32)
        q_m = self.param(f"q_m_{suffix}", nn.initializers.ones, (1,),
                         jnp.float32)
        t = (
            self.param(f"t_quant_{suffix}", nn.initializers.ones, (1,),
                       jnp.float32)
            if self.config.nonlinear
            else None
        )
        return d, q_m, t

    def _quantize(self, x, d, q_m, t, clip):
        clip_val = jnp.asarray(clip, x.dtype)
        q_s = jnp.asarray(0.0, x.dtype)
        if self.config.use_dge:
            return dge(x, d, q_m, clip_val, q_s, jnp.asarray(self.config.dge_bits))
        if self.config.nonlinear:
            return lsfq_nonlinear(x, d, q_m, t, clip_val, q_s)
        return lsfq_linear(x, d, q_m, clip_val, q_s)


class QuantDense(nn.Module, _QuantParamsMixin):
    """Dense layer with LSFQ weight (+activation) fake-quantization.

    The training-time forward — real-INT serving goes through
    ``artifact``/``serve`` which consume this layer's exported levels.
    """

    features: int
    config: QuantConfig = QuantConfig.off()
    use_bias: bool = True
    kernel_init: Any = nn.initializers.truncated_normal(stddev=0.01)
    bias_init: Any = nn.initializers.zeros
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features),
            jnp.float32,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), jnp.float32)
            if self.use_bias
            else None
        )
        if self.config.enabled:
            d_w, qm_w, t_w = self._declare_quant_params("wt")
            kernel = self._quantize(kernel, d_w, qm_w, t_w, self.config.weight_clip)
            if self.config.quantize_acts:
                d_a, qm_a, t_a = self._declare_quant_params("act")
                x = self._quantize(x, d_a, qm_a, t_a, self.config.act_clip)
        xd, kd, mixed = _mm_cast(self.config, x, kernel)
        y = (jnp.dot(xd, kd, preferred_element_type=jnp.float32)
             if mixed else jnp.dot(xd, kd))
        if bias is not None:
            y = y + bias
        return y


class QuantConv(nn.Module, _QuantParamsMixin):
    """Conv with LSFQ weight (+activation) fake-quantization (NHWC, HWIO)."""

    features: int
    kernel_size: Tuple[int, int]
    strides: Tuple[int, int] = (1, 1)
    padding: Any = "SAME"
    config: QuantConfig = QuantConfig.off()
    use_bias: bool = True
    feature_group_count: int = 1   # = features for depthwise convs
    kernel_init: Any = nn.initializers.kaiming_normal()
    bias_init: Any = nn.initializers.zeros

    @nn.compact
    def __call__(self, x):
        kernel = self.param(
            "kernel",
            self.kernel_init,
            (*self.kernel_size, x.shape[-1] // self.feature_group_count,
             self.features),
            jnp.float32,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), jnp.float32)
            if self.use_bias
            else None
        )
        quant_on = self.config.enabled
        if quant_on:
            d_w, qm_w, t_w = self._declare_quant_params("wt")
            kernel = self._quantize(kernel, d_w, qm_w, t_w,
                                    self.config.weight_clip)
            if self.config.quantize_acts:
                d_a, qm_a, t_a = self._declare_quant_params("act")

        # Non-overlapping patch convs (stride == kernel, VALID, ungrouped
        # — the ViT patch embed) run as the EXACT space-to-depth GEMM.
        # With a trainable activation quantizer here, its (d, q_m, t)
        # scalar grads need g = dL/d(quantized input), and for the conv
        # form XLA emits a transposed conv back to [B, H, W, 3] — a
        # 3-output-channel conv that maps badly onto matrix units. The
        # GEMM form's input gradient is an ordinary [*, D] x [D, p*p*C]
        # dot. Quantization surface unchanged: the per-tensor
        # quantizer is permutation-invariant, so quantizing the
        # patchified view equals quantizing the image (f32 reduction
        # order in the scalar grads differs; values identical).
        ks = tuple(self.kernel_size)
        if (tuple(self.strides) == ks and self.feature_group_count == 1
                and self.padding == "VALID" and x.ndim == 4
                and x.shape[1] % ks[0] == 0 and x.shape[2] % ks[1] == 0):
            b, H, W, C = x.shape
            ph, pw = ks
            xp = x.reshape(b, H // ph, ph, W // pw, pw, C)
            xp = xp.transpose(0, 1, 3, 2, 4, 5).reshape(
                b * (H // ph) * (W // pw), ph * pw * C)
            if quant_on and self.config.quantize_acts:
                xp = self._quantize(xp, d_a, qm_a, t_a,
                                    self.config.act_clip)
            xd, kd, mixed = _mm_cast(self.config, xp,
                                     kernel.reshape(ph * pw * C,
                                                    self.features))
            y = (jnp.dot(xd, kd, preferred_element_type=jnp.float32)
                 if mixed else jnp.dot(xd, kd))
            y = y.reshape(b, H // ph, W // pw, self.features)
            if bias is not None:
                y = y + bias
            return y

        if quant_on and self.config.quantize_acts:
            x = self._quantize(x, d_a, qm_a, t_a, self.config.act_clip)
        x, kernel, mixed = _mm_cast(self.config, x, kernel)
        y = jax.lax.conv_general_dilated(
            x,
            kernel,
            window_strides=self.strides,
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=self.feature_group_count,
            preferred_element_type=jnp.float32 if mixed else None,
        )
        if bias is not None:
            y = y + bias
        return y


class QuantConvTranspose(nn.Module, _QuantParamsMixin):
    """Transposed conv with LSFQ weight (+activation) fake-quantization.

    The counterpart of the reference's ConvTranspose2dOTO operator
    (operator.py:291-349). Torch ConvTranspose2d weights are [in, out, kh,
    kw] (hence its TRANSPOSE transform); flax kernels are [kh, kw, in, out],
    so pruning the out-channel axis uses the same Transform.OUT as Conv.
    NHWC / HWIO layouts.
    """

    features: int
    kernel_size: Tuple[int, int]
    strides: Tuple[int, int] = (1, 1)
    padding: Any = "SAME"
    config: QuantConfig = QuantConfig.off()
    use_bias: bool = True
    kernel_init: Any = nn.initializers.kaiming_normal()
    bias_init: Any = nn.initializers.zeros

    @nn.compact
    def __call__(self, x):
        kernel = self.param(
            "kernel",
            self.kernel_init,
            (*self.kernel_size, x.shape[-1], self.features),
            jnp.float32,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), jnp.float32)
            if self.use_bias
            else None
        )
        if self.config.enabled:
            d_w, qm_w, t_w = self._declare_quant_params("wt")
            kernel = self._quantize(kernel, d_w, qm_w, t_w, self.config.weight_clip)
            if self.config.quantize_acts:
                d_a, qm_a, t_a = self._declare_quant_params("act")
                x = self._quantize(x, d_a, qm_a, t_a, self.config.act_clip)
        y = jax.lax.conv_transpose(
            x,
            kernel,
            strides=self.strides,
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        if bias is not None:
            y = y + bias
        return y


def init_quant_params_tree(params, init_bits: float = 32.0):
    """Set each quantized layer's (d, q_m, t) from its float kernel.

    Functional analogue of initialize_quant_layer (quant_layers.py:413-440)
    applied across the whole params pytree: for every dict holding both a
    ``kernel`` and quant params, set q_m_* = max|kernel|,
    d_* = q_m / (2^(init_bits-1) - 1), t_* = 1. Weight and activation trios
    get identical initial values, as the reference does.
    """

    def visit(node):
        if not isinstance(node, dict):
            return node
        out = {k: visit(v) for k, v in node.items()}
        if "kernel" in out and "d_quant_wt" in out:
            k = out["kernel"]
            q_m = jnp.max(jnp.abs(k)).reshape(1).astype(k.dtype)
            d = (q_m / (2.0 ** (init_bits - 1.0) - 1.0)).astype(k.dtype)
            for suffix in ("wt", "act"):
                if f"d_quant_{suffix}" in out:
                    out[f"d_quant_{suffix}"] = d
                    out[f"q_m_{suffix}"] = q_m
                if f"t_quant_{suffix}" in out:
                    out[f"t_quant_{suffix}"] = jnp.ones((1,), k.dtype)
        return out

    import flax

    plain = flax.core.unfreeze(params) if hasattr(params, "unfreeze") else params
    return visit(plain)


def model_to_quantize_model(model, params, example_input,
                            quant: "QuantConfig" = None,
                            init_bits: float = 32.0):
    """Float model + params -> its quantized twin with initialized scalars.

    The reference mutates a torch module in place, swapping every
    Linear/Conv2d for QuantizeLinear/QuantizeConv2d and registering the
    learnable (d, q_m, t) parameters (quant_model.py:15-82 +
    initialize_quant_layer, quant_layers.py:413-440). Functionally here:
    rebuild the model with ``quant`` enabled in its config, take the
    quantized params *structure* from ``jax.eval_shape`` (zero FLOPs), copy
    every float leaf from the source tree, and initialize the new quant
    scalars from the weights (q_m = max|W|, d = q_m/(2^(b-1)-1), t = 1).

    Works for any family whose config dataclass carries a ``quant`` field
    (ViT, ResNet, Transformer, ConvAutoencoder, MobileNet). Returns
    (quant_model, quant_params).
    """
    import dataclasses

    import flax
    import numpy as np

    quant = quant or QuantConfig(enabled=True)
    if not hasattr(model, "cfg") or not hasattr(model.cfg, "quant"):
        raise ValueError(
            f"{type(model).__name__} has no quant-bearing config; construct "
            "the quantized variant directly")
    qmodel = type(model)(dataclasses.replace(model.cfg, quant=quant))
    abstract = jax.eval_shape(
        lambda: qmodel.init(jax.random.PRNGKey(0), example_input)
    )["params"]

    src = flax.core.unfreeze(params) if hasattr(params, "unfreeze") else params

    def fill(ab, have, path=""):
        if not isinstance(ab, (dict, flax.core.FrozenDict)):
            leaf = None if have is None else have
            if leaf is not None:
                if tuple(np.shape(leaf)) != tuple(ab.shape):
                    raise ValueError(
                        f"shape mismatch at {path}: source "
                        f"{np.shape(leaf)} vs quant model {ab.shape}")
                return jnp.asarray(leaf)
            # new quant scalar — placeholder; initialized just below
            return jnp.ones(ab.shape, ab.dtype)
        return {k: fill(v, None if have is None else have.get(k),
                        f"{path}/{k}" if path else k)
                for k, v in ab.items()}

    qparams = fill(abstract, src)
    return qmodel, init_quant_params_tree(qparams, init_bits=init_bits)


def collect_quant_params(params, prefix: str = ""):
    """{layer_path: {name: value}} for all quant scalars — the analogue of
    get_quant_param_dict (quant_model.py:85-101)."""
    found = {}

    def visit(node, path):
        if not isinstance(node, dict):
            return
        qp = {k: v for k, v in node.items() if k in QUANT_PARAM_NAMES}
        if qp:
            found[path] = qp
        for k, v in node.items():
            visit(v, f"{path}/{k}" if path else k)

    visit(params, prefix)
    return found


def bitwidth_dict(params):
    """{layer_path: {'weight_bit': b, 'act_bit': b}} using
    bits = log2(q_m^t/|d| + 1) + 1 — get_bitwidth_dict
    (quant_model.py:104-136)."""
    from ..quant.bitwidth import bit_width

    out = {}
    for path, qp in collect_quant_params(params).items():
        entry = {}
        t_w = qp.get("t_quant_wt")
        entry["weight_bit"] = float(
            bit_width(qp["d_quant_wt"], qp["q_m_wt"],
                      t_w if t_w is not None else None)[0]
        )
        if "d_quant_act" in qp:
            t_a = qp.get("t_quant_act")
            entry["act_bit"] = float(
                bit_width(qp["d_quant_act"], qp["q_m_act"],
                          t_a if t_a is not None else None)[0]
            )
        else:
            entry["act_bit"] = 32.0
        out[path] = entry
    return out
