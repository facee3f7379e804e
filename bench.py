"""Headline benchmark: ViT-B/16 W4A4 INT4 serving throughput on one GPU.

Prints ONE JSON line:
  {"metric": "vit_b16_w4a4_images_per_sec_chip", "value": N,
   "unit": "images/s", "vs_baseline": R, "device": {...}, "detail": {...}}

vs_baseline = speedup over the bf16 XLA forward of the same model on the
same card (the reference publishes no numbers — BASELINE.md — so the bf16
forward stands in for the float fake-quant path the reference runs).

Timing: every shape is compiled and warmed up first (compilation is set-up,
reported apart); then each timed call ends in ``block_until_ready``, and the
result is the median of ``REPS`` calls with its spread (min, max). The
script refuses to run without a GPU: a CPU number is not a device number.
Its bf16 baseline is the flax model, so it also refuses to run where flax
is not installed (``chip_smoke.py`` runs the serving path without it).
"""

import json
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

BATCH = 32
REPS = 30


def _time_calls(fn, *args):
    """(compile_s, median_s, min_s, max_s) of fn(*args) over REPS calls."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    for _ in range(3):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return compile_s, float(np.median(ts)), min(ts), max(ts)


def _card():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    try:
        import flax  # noqa: F401  (the bf16 baseline below)
    except ImportError as e:
        raise SystemExit(f"bench.py's bf16 baseline needs flax: {e}")

    from quantized_vit_tpu.cli._common import enable_compile_cache

    enable_compile_cache()

    from quantized_vit_tpu.configs import ViTConfig
    from quantized_vit_tpu.serve import (random_vit_int4_artifact,
                                         vit_int4_forward)
    from quantized_vit_tpu.utils.native_prep import patchify_batch

    cfg = ViTConfig(num_classes=1000)
    # unpacked-int8 weight storage (values are still int4 levels)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False)
    images = np.random.default_rng(0).standard_normal(
        (BATCH, 224, 224, 3)).astype(np.float32)
    # serving feeds the host-patchified layout; the bf16 baseline below
    # keeps NHWC + XLA conv
    images_p = jnp.asarray(patchify_batch(images, cfg.patch_size))

    def int4(x):
        return vit_int4_forward(art, x, cfg, float_dtype=jnp.bfloat16,
                                images_layout="patches")

    def int4_ia(x):
        return vit_int4_forward(art, x, cfg, float_dtype=jnp.bfloat16,
                                int_attention=True, images_layout="patches")

    art_packed = random_vit_int4_artifact(cfg, seed=0, pack_weights=True)

    def b1(x):
        return vit_int4_forward(art_packed, x, cfg,
                                float_dtype=jnp.bfloat16,
                                images_layout="patches")

    c_int4, t_int4, lo_int4, hi_int4 = _time_calls(int4, images_p)
    c_ia, t_ia, _, _ = _time_calls(int4_ia, images_p)
    c_b1, t_b1, lo_b1, hi_b1 = _time_calls(b1, images_p[:1])

    # bf16 baseline: same architecture, plain XLA bf16 matmuls (flax)
    from quantized_vit_tpu.models import QuantConfig, VisionTransformer

    model = VisionTransformer(ViTConfig(num_classes=1000,
                                        quant=QuantConfig.off()))
    images_bf16 = jnp.asarray(images, jnp.bfloat16)
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), images_bf16[:1])
    )["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda s: jnp.array(
            rng.standard_normal(s.shape).astype(np.float32) * 0.02,
            jnp.bfloat16),
        abstract,
    )
    bf16 = jax.jit(lambda p, x: model.apply({"params": p}, x))
    c_bf16, t_bf16, _, _ = _time_calls(bf16, params, images_bf16)

    ips_int4 = BATCH / t_int4
    ips_bf16 = BATCH / t_bf16
    print(json.dumps({
        "metric": "vit_b16_w4a4_images_per_sec_chip",
        "value": ips_int4,
        "unit": "images/s",
        "vs_baseline": ips_int4 / ips_bf16,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": _card()},
        "detail": {
            "batch": BATCH,
            "reps": REPS,
            "images_layout": "patches",
            "int4_ms_per_batch": t_int4 * 1e3,
            "int4_ms_per_batch_min_max": [lo_int4 * 1e3, hi_int4 * 1e3],
            "bf16_ms_per_batch": t_bf16 * 1e3,
            "bf16_images_per_sec": ips_bf16,
            "int8_attn_ms_per_batch": t_ia * 1e3,
            "latency_ms_batch1": t_b1 * 1e3,
            "latency_ms_batch1_min_max": [lo_b1 * 1e3, hi_b1 * 1e3],
            "compile_s": {"int4": c_int4, "int8_attn": c_ia,
                          "batch1": c_b1, "bf16": c_bf16},
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
