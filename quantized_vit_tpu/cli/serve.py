"""Serving driver: INT4 artifact + continuous batching load test.

Loads a ViT INT4 artifact (cli.export vit), starts the
:class:`ContinuousBatcher`, fires a synthetic request load at a target
rate, and reports throughput/latency/batch-occupancy — the serving half of
BASELINE.md's throughput target.

Multi-device serving (``--mesh-model N``) routes through the explicit
shard_map paths, never the GSPMD loader placement (the collectives audit,
parallel/audit.py, shows GSPMD resharding around every attention):

- ``--mesh-mode tp`` (default): Megatron-style tensor parallel
  (serve/vit_tp.py — int8 activation all-gathers, reduce-scatters,
  exactly 2 AG + 2 RS per block). The latency configuration.
- ``--mesh-mode fsdp``: weight-gather data parallel (serve/vit_fsdp.py —
  weights sharded over devices, 4 int-weight all-gathers per block,
  compute pure DP). The memory-sharded configuration for models that
  don't fit one card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT INT4 serving load test")
    p.add_argument("--artifact", required=True)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=0.0,
                   help="request arrival rate /s (0 = as fast as possible)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--mesh-model", type=int, default=0,
                   help="model-axis size for multi-device serving (0=off)")
    p.add_argument("--mesh-mode", choices=["tp", "fsdp"], default="tp",
                   help="tp: explicit shard_map tensor parallel (latency); "
                        "fsdp: weight-gather data parallel (memory-sharded)")
    p.add_argument("--input-uint8", action="store_true",
                   help="serve uint8 pixel inputs (JPEG-decoded bytes; "
                        "4x less host->device transfer — the production "
                        "input mode; cast+scale runs on device)")
    return p.parse_args(argv)


def build_forward(args):
    """Artifact + flags -> (forward(images)->logits, cfg, batcher buckets).

    Split out of main() so tests and chip_smoke.py drive the function the
    CLI actually serves."""
    import jax
    import jax.numpy as jnp

    from ..artifact.vit import load_vit_int4_artifact
    from ..serve.vit_int4 import vit_int4_forward
    from ..utils.native_prep import patchify_batch, patchify_batch_u8

    art, cfg = load_vit_int4_artifact(args.artifact)

    # --input-uint8: upload uint8 patch bytes (4x fewer host->device bytes
    # than f32) and cast+scale on device (the forwards' input_scale)
    if args.input_uint8:
        def patchify(images):
            return patchify_batch_u8(np.asarray(images, np.uint8),
                                     cfg.patch_size)
        input_scale = 1.0 / 255.0
    else:
        def patchify(images):
            return patchify_batch(np.asarray(images, np.float32),
                                  cfg.patch_size)
        input_scale = None

    buckets = None
    if args.mesh_model:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        n = args.mesh_model
        devs = np.array(jax.devices())
        if devs.size < n:
            raise SystemExit(
                f"--mesh-model {n} needs that many devices; have "
                f"{devs.size}")
        mesh = Mesh(devs[:n].reshape(1, n), axis_names=("data", "model"))
        if args.mesh_mode == "tp":
            from ..serve.vit_tp import (prepare_tp_artifact,
                                        shard_tp_artifact,
                                        vit_int4_forward_tp)

            art_m = shard_tp_artifact(
                prepare_tp_artifact(art, cfg, n), mesh)
            fwd_fn = vit_int4_forward_tp
        else:
            from ..serve.vit_fsdp import (prepare_fsdp_artifact,
                                          shard_fsdp_artifact,
                                          vit_int4_forward_fsdp)

            art_m = shard_fsdp_artifact(
                prepare_fsdp_artifact(art, cfg, n), mesh)
            fwd_fn = vit_int4_forward_fsdp

        # batch buckets must divide over the mesh: multiples of n only
        cap = max(args.max_batch, n)
        buckets = [n]
        while buckets[-1] * 2 <= cap:
            buckets.append(buckets[-1] * 2)
        if buckets[-1] < cap and cap % n == 0:
            buckets.append(cap)
        x_sharding = NamedSharding(mesh, P(("data", "model")))

        def forward(images):
            x = jax.device_put(patchify(images), x_sharding)
            return np.asarray(
                fwd_fn(art_m, x, cfg, mesh, float_dtype=jnp.bfloat16,
                       images_layout="patches", input_scale=input_scale))

        # introspection hooks for the CLI-level routing test
        # (tests/cli/test_cli_drivers.py pins the collective schedule of
        # the function the CLI actually serves)
        forward.fwd_fn = fwd_fn
        forward.mesh = mesh
        forward.artifact = art_m
        forward.x_sharding = x_sharding
        return forward, cfg, buckets

    # single device: host-side patchify in the batcher's dispatch thread,
    # overlapped with the device step (vit_int4_forward images_layout)
    def forward(images):
        return np.asarray(
            vit_int4_forward(art, jnp.asarray(patchify(images)), cfg,
                             images_layout="patches",
                             input_scale=input_scale))

    return forward, cfg, buckets


def main(argv=None):
    args = parse_args(argv)

    from ..serve import ContinuousBatcher

    forward, cfg, buckets = build_forward(args)

    rng = np.random.default_rng(0)
    if args.input_uint8:
        example = rng.integers(
            0, 256, (cfg.img_size, cfg.img_size, 3)).astype(np.uint8)
    else:
        example = rng.standard_normal(
            (cfg.img_size, cfg.img_size, 3)).astype(np.float32)

    # mesh serving: cap max_batch at the largest mesh-divisible bucket —
    # the batcher appends max_batch as a bucket when it exceeds buckets[-1],
    # and a bucket not divisible by the device count would fail the
    # sharded forward's b % n_dev check at warmup
    max_batch = buckets[-1] if buckets else args.max_batch
    if max_batch != args.max_batch:
        print(f"[serve] capping max_batch {args.max_batch} -> {max_batch} "
              "(mesh divisibility)")
    batcher = ContinuousBatcher(forward, max_batch=max_batch,
                                max_delay_ms=args.max_delay_ms,
                                buckets=buckets)
    print("[serve] warming buckets", batcher.buckets)
    batcher.warmup(example)

    lat = []
    t0 = time.time()
    with batcher:
        futs = []
        for i in range(args.requests):
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
            futs.append((time.monotonic(), batcher.submit(example)))
        for t_sub, f in futs:
            f.result(timeout=120)
            lat.append(time.monotonic() - t_sub)
    wall = time.time() - t0

    out = {
        "requests": args.requests,
        "wall_s": round(wall, 3),
        "throughput_rps": round(args.requests / wall, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "batches": batcher.stats["batches"],
        "padded": batcher.stats["padded"],
        "batch_hist": batcher.stats["batch_hist"],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    from ._common import enable_compile_cache

    enable_compile_cache()
    main()
