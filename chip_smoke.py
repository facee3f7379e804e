"""On-card smoke test of the INT4 ViT-B/16 serving path.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # only the TP and FSDP paths on 4 cards

One card: ViT-B/16 at its published widths (img 224, patch 16, dim 768,
depth 12, 12 heads, 1000 classes) with random weights from ``--seed``, in
both weight formats (int8 storage and packed int4), through
``serve.vit_int4_forward`` at batch 32 (bf16 serving and f32 parity
configurations) and batch 1. It checks the card's forward, one stage at a
time, against the same forward on the host CPU and against the float32
reference (``serve/reference.py``), serves 64 requests through ``cli.serve``'s
forward behind ``ContinuousBatcher`` (uint8 and float input), and prints
smoke timings labelled with the card. ``--four-cards`` runs
``cli.serve.build_forward`` with ``--mesh-model 4`` in both mesh modes and
compares each with the single-card forward on card 0.

Any failed check raises and exits nonzero. Without a GPU the script exits
nonzero before printing any result. The last line of a passing run is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

BATCH = 32
N_CHECK = 8        # images of check (a), card vs host CPU
N_REQUESTS = 64
TIMED_CALLS = 20
DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}

# Every bounded comparison of two implementations runs one stage at a time
# (embedding, each block's attention half and MLP half, head), both sides
# fed the same input. End to end, the W4A4 forward is chaotic: any float
# difference between two implementations (an erf/exp2/rsqrt ulp, another
# summation order) sooner or later moves a value across a rounding tie of
# a 4-bit quantizer, and one level flip spreads through the next dots and
# quantizers until the logits differ by tens of percent. On the CPU,
# scaling ViT-B/16's position embedding by 1 + 1e-5 moves the logits of 8
# images by 0.32 relative L2; with activation steps fitted to the
# LayerNorm output, or branches 100x smaller than the residual stream,
# still by 0.06-0.27. So end-to-end errors are printed, not bounded.
#
# (a) The card against the host CPU, f32 residual stream. Integer
# accumulations are exact on both and the f32 epilogues are elementwise,
# so within a stage only a level flip at a rounding tie separates them;
# one flip moves a stage's output by well under 1e-3 of its norm.
CPU_PARITY_BOUND = 1e-3

# (b) The card against the float32 reference (serve/reference.py) on the
# host CPU, on all BATCH images, each stage fed the reference's output of
# the stage before (rounded to the residual dtype): twice the largest
# stage error of the same comparison with the int path on the CPU
# (ViT-B/16, seed 0: 2.040e-4 in f32, 8.606e-3 in bf16 —
# tests/test_chip_smoke.py::test_reference_bounds_are_twice_the_cpu_error),
# never below 1e-4. The reference sums the dots in float where the int
# path sums exactly (f32), and in bf16 the int path also rounds qkv,
# attention probabilities and the residual stream. On 8 images that
# largest error moves between 1.7e-4 and 3.6e-4 with the images (f32); on
# 32 it settles, hence all BATCH images here. A wrong stage (unmasked pad
# keys, a lost bias, a mis-scaled layer) is off by 1e-2 or more.
REFERENCE_BOUND = {
    ("int8", "float32"): 4.08e-4,
    ("int8", "bfloat16"): 1.722e-2,
    ("int4", "float32"): 4.08e-4,
    ("int4", "bfloat16"): 1.722e-2,
}

# Four cards against the single-card forward on card 0, with the
# tolerances of tests/serve/test_vit_tp.py. f32: FSDP gathers whole weights
# and runs the single-card block, so its logits must match card 0's within
# MESH_F32_ATOL. TP sums its dequantized f32 partials across the cards in
# another order, an ulp-level change that the chaos noted above grows end
# to end; its blocks are compared one at a time from the same input, at
# CPU_PARITY_BOUND for the same reason as (a), and its end-to-end logits
# are printed. bf16 (as served), both modes: the mesh's bf16 logits no
# further from its f32 logits than 1.5x the single card's bf16 logits are
# (+1e-6).
MESH_F32_ATOL = 1e-4


def card_line() -> str:
    """Name and power limit of each card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu(devices) -> None:
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {devices[0].platform}")


def optional_imports() -> dict:
    """Whether flax, orbax.checkpoint and torch import (information for
    the training path; the serving path needs none of them)."""
    out = {}
    for name in ("flax", "orbax.checkpoint", "torch"):
        try:
            importlib.import_module(name)
            out[name] = "imports"
        except Exception as e:  # report any failure mode, never fail on it
            out[name] = f"does not import ({type(e).__name__}: {e})"
    return out


def vit_b16():
    from quantized_vit_tpu.configs import ViTConfig

    return ViTConfig(num_classes=1000)


def make_artifacts(cfg, seed: int) -> dict:
    """Both weight formats; the same seed gives the same levels."""
    from quantized_vit_tpu.serve import random_vit_int4_artifact

    return {"int8": random_vit_int4_artifact(cfg, seed, pack_weights=False),
            "int4": random_vit_int4_artifact(cfg, seed, pack_weights=True)}


def make_patches(cfg, batch: int, seed: int) -> np.ndarray:
    """Seeded images in the host-patchified serving layout."""
    from quantized_vit_tpu.utils.native_prep import patchify_batch

    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch, cfg.img_size, cfg.img_size, cfg.in_channels))
    return patchify_batch(images.astype(np.float32), cfg.patch_size)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _forward(art, x, cfg, dtype):
    from quantized_vit_tpu.serve import vit_int4_forward

    return vit_int4_forward(art, x, cfg, float_dtype=DTYPES[dtype],
                            images_layout="patches")


def run_forwards(arts: dict, patches: np.ndarray, cfg, device):
    """Forward every (format, dtype) at the full batch and (bf16) at batch
    1 on ``device``. Returns ({(fmt, dtype, batch): logits}, compile_s) —
    compile_s sums the first calls, which trace and compile."""
    logits, compile_s = {}, 0.0
    x = jax.device_put(patches, device)
    for fmt, art in arts.items():
        art_d = jax.device_put(art, device)
        for dtype, xb in (("bfloat16", x), ("float32", x),
                          ("bfloat16", x[:1])):
            t0 = time.perf_counter()
            y = jax.block_until_ready(_forward(art_d, xb, cfg, dtype))
            compile_s += time.perf_counter() - t0
            y = np.asarray(y, np.float32)
            if y.shape != (xb.shape[0], cfg.num_classes):
                raise RuntimeError(f"{fmt}/{dtype}: logits shape {y.shape}")
            if not np.isfinite(y).all():
                raise RuntimeError(f"{fmt}/{dtype}: non-finite logits")
            logits[(fmt, dtype, xb.shape[0])] = y
    return logits, compile_s


def _stages(cfg, dtype, b: int):
    """The int path as jitted stages (embedding, attention half, MLP half,
    head), each mapping the previous stage's output to its own."""
    from quantized_vit_tpu.serve.vit_int4 import (_attn_branch,
                                                  _embed_tokens, _head,
                                                  _mlp_branch, _round_up)

    fdt = DTYPES[dtype]
    n_pad = _round_up(cfg.num_tokens, 16)
    hd = cfg.embed_dim // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5
    embed = jax.jit(lambda art, x: _embed_tokens(art, x, cfg, fdt,
                                                 "patches")[0])
    attn = jax.jit(lambda blk, x2d: _attn_branch(
        x2d.astype(fdt), blk, b=b, n_pad=n_pad, n_real=cfg.num_tokens,
        hd=hd, sm_scale=sm_scale, float_dtype=fdt, int_attention=False))
    mlp = jax.jit(lambda blk, x2d: _mlp_branch(x2d.astype(fdt), blk, fdt))
    head = jax.jit(lambda art, x2d: _head(x2d.astype(fdt).reshape(
        b, n_pad, cfg.embed_dim)[:, cfg.num_tokens - 1], art))
    return embed, attn, mlp, head


def _reference_stages(cfg):
    """The float32 reference as the same four kinds of jitted stage."""
    from quantized_vit_tpu.serve.reference import (reference_attn,
                                                   reference_embed,
                                                   reference_head,
                                                   reference_mlp)

    return (jax.jit(lambda art, x: reference_embed(art, x, cfg, "patches")),
            jax.jit(lambda blk, x: reference_attn(x, blk, cfg)),
            jax.jit(lambda blk, x: reference_mlp(x, blk)),
            jax.jit(lambda art, x: reference_head(x, art)))


def _chain(art, stages) -> list:
    """[(name, stage, its weights)] of the whole forward, in order."""
    embed, attn, mlp, head = stages
    out = [("embedding", embed, art)]
    for i, blk in enumerate(art["blocks"]):
        out += [(f"block {i} attn", attn, blk), (f"block {i} mlp", mlp, blk)]
    return out + [("head", head, art)]


def _int_rows(x_ref, n_pad: int) -> np.ndarray:
    """Reference tokens [B, N, D] (cls first) -> the int path's rows
    [B * n_pad, D] (patches, then cls, then zero pad rows)."""
    x = np.asarray(x_ref, np.float32)
    b, n, dim = x.shape
    x = np.concatenate([x[:, 1:], x[:, :1],
                        np.zeros((b, n_pad - n, dim), np.float32)], axis=1)
    return x.reshape(b * n_pad, dim)


def _ref_rows(x2d, b: int, n_real: int) -> np.ndarray:
    """The int path's rows [B * n_pad, D] -> reference order [B, N, D]."""
    x = np.asarray(x2d, np.float32).reshape(b, -1, x2d.shape[-1])[:, :n_real]
    return np.concatenate([x[:, n_real - 1:], x[:, :n_real - 1]], axis=1)


def stage_errors(art, patches, cfg, dtype, dev, cpu) -> list:
    """Relative L2 between ``dev`` and ``cpu`` of every stage's output
    (embedding, each block's attention and MLP halves, head), each stage
    fed on both devices with the CPU's output of the stage before. Returns
    [(name, err)]."""
    stages = _stages(cfg, dtype, patches.shape[0])
    chain_c = _chain(jax.device_put(art, cpu), stages)
    chain_d = _chain(jax.device_put(art, dev), stages)
    errs = []
    x_c = jax.device_put(patches, cpu)
    for (name, fn, w_c), (_, _, w_d) in zip(chain_c, chain_d):
        out_c = fn(w_c, x_c)
        errs.append((name, rel_l2(fn(w_d, jax.device_put(x_c, dev)),
                                  out_c)))
        x_c = out_c
    return errs


def check_cpu_parity(arts, patches, logits, cfg, device, cpu) -> dict:
    """(a): the card against the host CPU on the first N_CHECK images, f32
    residual stream. Every stage, fed the same input on both devices, must
    agree within CPU_PARITY_BOUND; the end-to-end logits are printed as
    information (see the note at CPU_PARITY_BOUND)."""
    x = patches[:N_CHECK]
    out = {}
    for fmt, art in arts.items():
        want = np.asarray(_forward(jax.device_put(art, cpu),
                                   jax.device_put(x, cpu), cfg, "float32"))
        got = logits[(fmt, "float32", patches.shape[0])][:N_CHECK]
        top1 = float((got.argmax(-1) == want.argmax(-1)).mean())
        print(f"check (a) {fmt} f32 end to end, card vs host CPU: logits "
              f"rel L2 {rel_l2(got, want):.3e}, top-1 agreement {top1:.3f} "
              "(information)", flush=True)
        errs = stage_errors(art, x, cfg, "float32", device, cpu)
        worst = max(errs, key=lambda e: e[1])
        print(f"check (a) {fmt} f32 per stage, card vs host CPU from the "
              f"same input: max rel L2 {worst[1]:.3e} at {worst[0]} (bound "
              f"{CPU_PARITY_BOUND:.0e}); "
              + ", ".join(f"{n} {e:.1e}" for n, e in errs), flush=True)
        bad = [(n, e) for n, e in errs if e > CPU_PARITY_BOUND]
        if bad:
            raise RuntimeError(f"check (a) {fmt} failed: first divergent "
                               f"stage {bad[0][0]} (rel L2 {bad[0][1]:.3e})")
        out[fmt] = worst[1]
    return out


def reference_stage_errors(art, patches, cfg, dtype, dev, cpu) -> list:
    """Relative L2 between the int path on ``dev`` and the float32
    reference on ``cpu`` of every stage's output (embedding, each block's
    attention and MLP halves, head), each stage fed the reference's output
    of the stage before, rounded to the residual stream's dtype. Returns
    [(name, err)]."""
    b, n_real = patches.shape[0], cfg.num_tokens
    n_pad = -(-n_real // 16) * 16
    chain = _chain(jax.device_put(art, dev), _stages(cfg, dtype, b))
    chain_ref = _chain(jax.device_put(art, cpu), _reference_stages(cfg))
    errs = []
    x_ref = patches
    for k, ((name, fn, w_d), (_, ref_fn, w_c)) in enumerate(
            zip(chain, chain_ref)):
        if k:   # both get the residual stream as the int path holds it
            x_ref = np.asarray(jnp.asarray(x_ref, DTYPES[dtype]), np.float32)
        y_ref = np.asarray(ref_fn(w_c, jax.device_put(x_ref, cpu)))
        x_in = patches if k == 0 else _int_rows(x_ref, n_pad)
        got = fn(w_d, jax.device_put(x_in, dev))
        if y_ref.ndim == 3:   # residual stream; the head gives logits
            got = _ref_rows(got, b, n_real)
        errs.append((name, rel_l2(got, y_ref)))
        x_ref = y_ref
    return errs


def reference_errors(arts, patches, logits, cfg, dev, cpu,
                     bounds=None) -> dict:
    """(b): the int path on ``dev`` in f32 and bf16 against the float32
    reference on the host CPU, on all of ``patches``, one stage at a time
    (:func:`reference_stage_errors`). Returns the largest stage error of
    each (format, dtype); with ``bounds`` each must stay within its bound.
    The end-to-end logits are printed as information."""
    from quantized_vit_tpu.serve import vit_reference_forward

    x = patches
    out = {}
    for fmt, art in arts.items():
        ref = np.asarray(vit_reference_forward(
            jax.device_put(art, cpu), jax.device_put(x, cpu), cfg,
            images_layout="patches"))
        for dtype in DTYPES:
            errs = reference_stage_errors(art, x, cfg, dtype, dev, cpu)
            worst = max(errs, key=lambda e: e[1])
            out[(fmt, dtype)] = worst[1]
            if bounds is None:
                continue
            got = logits[(fmt, dtype, patches.shape[0])]
            print(f"check (b) {fmt} {dtype} end to end vs float32 "
                  f"reference: logits rel L2 {rel_l2(got, ref):.3e} "
                  "(information)", flush=True)
            print(f"check (b) {fmt} {dtype} per stage vs float32 reference "
                  f"from the same input: max rel L2 {worst[1]:.3e} at "
                  f"{worst[0]} (bound {bounds[(fmt, dtype)]:.3e}); "
                  + ", ".join(f"{n} {e:.1e}" for n, e in errs), flush=True)
            bad = [(n, e) for n, e in errs if e > bounds[(fmt, dtype)]]
            if bad:
                raise RuntimeError(
                    f"check (b) {fmt} {dtype} failed: first divergent stage "
                    f"{bad[0][0]} (rel L2 {bad[0][1]:.3e} > "
                    f"{bounds[(fmt, dtype)]:.3e})")
    return out


def served_phase(cfg, art, input_uint8: bool, n_requests: int, seed: int,
                 max_batch: int = 8) -> float:
    """Save ``art``, serve ``n_requests`` seeded images through
    cli.serve.build_forward + ContinuousBatcher as ``cli.serve.main``
    does, and compare each answer with a direct vit_int4_forward of the
    same image, run in a batch of the size it was served in (a GPU may
    pick other dot algorithms for another batch size, and the chaos noted
    at CPU_PARITY_BOUND grows that to ~0.2). Returns the largest relative
    L2."""
    from quantized_vit_tpu.artifact.vit import save_vit_int4_artifact
    from quantized_vit_tpu.cli import serve as serve_cli
    from quantized_vit_tpu.serve import ContinuousBatcher, vit_int4_forward
    from quantized_vit_tpu.utils.native_prep import (patchify_batch,
                                                     patchify_batch_u8)

    rng = np.random.default_rng(seed)
    shape = (n_requests, cfg.img_size, cfg.img_size, cfg.in_channels)
    if input_uint8:
        images = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        images = rng.standard_normal(shape).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        save_vit_int4_artifact(d, art, cfg)
        args = serve_cli.parse_args(
            ["--artifact", d, "--max-batch", str(max_batch)]
            + (["--input-uint8"] if input_uint8 else []))
        forward, cfg_l, buckets = serve_cli.build_forward(args)

    calls = []   # (batch as dispatched, its logits)

    def recorded(batch):
        out = forward(batch)
        calls.append((np.array(batch), np.asarray(out)))
        return out

    batcher = ContinuousBatcher(recorded, max_batch=args.max_batch,
                                max_delay_ms=args.max_delay_ms,
                                buckets=buckets)
    batcher.warmup(images[0])
    calls.clear()
    with batcher:
        futs = [batcher.submit(img) for img in images]
        served = [np.asarray(f.result(timeout=600)) for f in futs]

    worst, found = 0.0, np.zeros(n_requests, bool)
    for batch, out in calls:   # the direct forward of each served batch
        if input_uint8:
            x = patchify_batch_u8(batch, cfg.patch_size)
            scale = 1.0 / 255.0
        else:
            x = patchify_batch(batch, cfg.patch_size)
            scale = None
        want = np.asarray(vit_int4_forward(
            art, jnp.asarray(x), cfg_l, images_layout="patches",
            input_scale=scale))
        for i, img in enumerate(images):
            rows = [r for r in range(len(batch))
                    if np.array_equal(batch[r], img)]
            if rows:
                found[i] = True
                worst = max(worst, rel_l2(served[i], want[rows[0]]))
    mode = "uint8" if input_uint8 else "float"
    print(f"served path ({mode} input, {n_requests} requests, buckets "
          f"{batcher.buckets}, batch sizes {batcher.stats['batch_hist']}): "
          f"max rel L2 vs direct forward {worst:.3e} "
          f"(bound {CPU_PARITY_BOUND:.0e})", flush=True)
    if not found.all() or worst > CPU_PARITY_BOUND:
        raise RuntimeError(f"served path ({mode}) answers differ: {worst}")
    return worst


def _timed(fn, *args):
    jax.block_until_ready(fn(*args))  # warm-up after the compile
    ts = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), min(ts), max(ts)


def timing_phase(arts, patches, cfg, device, label: str) -> dict:
    """Smoke timings (not benchmark cells): bf16 ms per batch at the full
    batch and at batch 1, for each weight format."""
    x = jax.device_put(patches, device)
    out = {}
    for fmt, art in arts.items():
        art_d = jax.device_put(art, device)
        for xb in (x, x[:1]):
            med, lo, hi = _timed(
                lambda a, b: _forward(a, b, cfg, "bfloat16"), art_d, xb)
            out[(fmt, xb.shape[0])] = (med, lo, hi)
            print(f"smoke timing [{label}] batch {xb.shape[0]} bf16 {fmt} "
                  f"storage: median {med:.3f} ms, min {lo:.3f}, max "
                  f"{hi:.3f} ({TIMED_CALLS} block_until_ready calls)",
                  flush=True)
    return out


def tp_block_errors(art, forward, patches, cfg, dev0) -> list:
    """Relative L2 between each f32 block of the TP forward behind
    ``forward`` (cli.serve.build_forward, --mesh-mode tp) and the same
    block on ``dev0`` alone, both fed dev0's output of the block before.
    Returns [(name, err)]."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quantized_vit_tpu.serve.vit_tp import tp_artifact_specs, tp_block

    b, n_real = patches.shape[0], cfg.num_tokens
    n_pad = -(-n_real // 16) * 16
    hd = cfg.embed_dim // cfg.num_heads
    sm_scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5
    mesh, tp = forward.mesh, forward.mesh.shape["model"]
    rows = P(("data", "model"))
    spec = tp_artifact_specs(forward.artifact)["blocks"][0]  # uniform
    mesh_block = jax.jit(jax.shard_map(
        lambda blk, x: tp_block(
            x, blk, b_grp=x.shape[0] // n_pad * tp, n_pad=n_pad,
            n_real=n_real, hd=hd, sm_scale=sm_scale,
            float_dtype=jnp.float32, comm_dtype=jnp.float32),
        mesh=mesh, in_specs=(spec, rows), out_specs=rows, check_vma=False))
    embed, attn, mlp, _ = _stages(cfg, "float32", b)
    art0 = jax.device_put(art, dev0)
    x = embed(art0, jax.device_put(patches, dev0))
    errs = []
    for i, (blk0, blk_m) in enumerate(zip(art0["blocks"],
                                          forward.artifact["blocks"])):
        want = mlp(blk0, attn(blk0, x))
        got = mesh_block(blk_m, jax.device_put(x, NamedSharding(mesh, rows)))
        errs.append((f"block {i}", rel_l2(_ref_rows(got, b, n_real),
                                          _ref_rows(want, b, n_real))))
        x = want
    return errs


def four_card_phase(cfg, art, n: int, mode: str, seed: int,
                    batch: int = BATCH) -> dict:
    """cli.serve.build_forward with ``--mesh-model n`` in ``mode``
    ('tp'|'fsdp') against the single-card forward on device 0."""
    from quantized_vit_tpu.artifact.vit import save_vit_int4_artifact
    from quantized_vit_tpu.cli import serve as serve_cli
    from quantized_vit_tpu.serve import vit_int4_forward
    from quantized_vit_tpu.utils.native_prep import patchify_batch

    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch, cfg.img_size, cfg.img_size, cfg.in_channels)
    ).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        save_vit_int4_artifact(d, art, cfg)
        args = serve_cli.parse_args(["--artifact", d, "--mesh-model", str(n),
                                     "--mesh-mode", mode])
        forward, cfg_l, _ = serve_cli.build_forward(args)
    served = np.asarray(forward(images), np.float32)   # bf16, as served
    patches = patchify_batch(images, cfg.patch_size)
    x_mesh = jax.device_put(patches, forward.x_sharding)
    comm = {"comm_dtype": jnp.float32} if mode == "tp" else {}
    exact = np.asarray(forward.fwd_fn(
        forward.artifact, x_mesh, cfg_l, forward.mesh,
        float_dtype=jnp.float32, images_layout="patches", **comm))
    dev0 = jax.devices()[0]
    art0 = jax.device_put(art, dev0)
    x0 = jax.device_put(patches, dev0)
    single = {dt: np.asarray(vit_int4_forward(
        art0, x0, cfg_l, float_dtype=DTYPES[dt], images_layout="patches"),
        np.float32) for dt in DTYPES}
    out = {"f32_rel_l2": rel_l2(exact, single["float32"]),
           "f32_max_abs": float(np.abs(exact - single["float32"]).max()),
           "bf16_dev": float(np.abs(served - exact).max()),
           "bf16_dev_single": float(np.abs(single["bfloat16"] - exact).max())}
    top1 = float((exact.argmax(-1) == single["float32"].argmax(-1)).mean())
    print(f"{mode} x{n}: f32 mesh vs f32 card 0 end to end: rel L2 "
          f"{out['f32_rel_l2']:.3e}, max abs {out['f32_max_abs']:.3e}, top-1 "
          f"agreement {top1:.3f}; bf16 served vs f32 mesh max abs "
          f"{out['bf16_dev']:.3e} (bound 1.5 x single-card bf16 "
          f"{out['bf16_dev_single']:.3e} + 1e-6)", flush=True)
    if out["bf16_dev"] > 1.5 * out["bf16_dev_single"] + 1e-6:
        raise RuntimeError(f"{mode}: bf16 mesh logits deviate "
                           f"{out['bf16_dev']}")
    if mode == "fsdp":
        print(f"fsdp x{n}: f32 max abs {out['f32_max_abs']:.3e} (bound "
              f"{MESH_F32_ATOL:.0e})", flush=True)
        if out["f32_max_abs"] > MESH_F32_ATOL:
            raise RuntimeError(f"fsdp: f32 mesh logits differ: "
                               f"{out['f32_max_abs']}")
        return out
    errs = tp_block_errors(art, forward, patches, cfg_l, dev0)
    out["block_max_rel_l2"] = worst = max(e for _, e in errs)
    print(f"tp x{n}: f32 per block vs card 0 from the same input: max rel "
          f"L2 {worst:.3e} (bound {CPU_PARITY_BOUND:.0e}); "
          + ", ".join(f"{name} {e:.1e}" for name, e in errs), flush=True)
    bad = [(name, e) for name, e in errs if e > CPU_PARITY_BOUND]
    if bad:
        raise RuntimeError(f"tp: first divergent block {bad[0][0]} (rel L2 "
                           f"{bad[0][1]:.3e})")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card TP and FSDP serving paths")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    dev = devices[0]
    card = card_line()
    label = card.splitlines()[0]
    print(f"card (nvidia-smi name, power.limit): {card}")
    print(f"jax: platform {dev.platform}, device_kind {dev.device_kind}, "
          f"count {len(devices)}")
    for name, status in optional_imports().items():
        print(f"optional import {name}: {status}")

    from quantized_vit_tpu.cli._common import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)

    cfg = vit_b16()
    if args.four_cards:
        n = 4
        if len(devices) < n:
            raise SystemExit(f"--four-cards needs {n} GPUs; have "
                             f"{len(devices)}")
        art = make_artifacts(cfg, args.seed)["int4"]
        for mode in ("tp", "fsdp"):
            four_card_phase(cfg, art, n, mode, args.seed)
    else:
        arts = make_artifacts(cfg, args.seed)
        patches = make_patches(cfg, BATCH, args.seed)
        cpu = jax.devices("cpu")[0]
        logits, compile_s = run_forwards(arts, patches, cfg, dev)
        print(f"forward on the card: {len(logits)} (format, dtype, batch) "
              f"runs, logits finite, first calls {compile_s:.1f} s "
              "(trace + compile + run)", flush=True)
        check_cpu_parity(arts, patches, logits, cfg, dev, cpu)
        reference_errors(arts, patches, logits, cfg, dev, cpu,
                         bounds=REFERENCE_BOUND)
        for input_uint8 in (True, False):
            served_phase(cfg, arts["int8"], input_uint8, N_REQUESTS,
                         args.seed)
        timing_phase(arts, patches, cfg, dev, label)
        peak = dev.memory_stats()["peak_bytes_in_use"]
        print(f"peak device memory [{label}]: {peak} bytes", flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
