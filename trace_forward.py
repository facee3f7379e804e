"""Profile the INT4 ViT-B/16 serving forward on one GPU and summarise it.

Run from the repository root on a machine with an NVIDIA GPU:

    python trace_forward.py [--out DIR] [--batch 32] [--reps 3]

It builds the same seeded artifact and images as ``chip_smoke.py``, warms
up ``vit_int4_forward`` (bf16 residual, patches layout) at ``--batch`` and
at batch 1 in both weight formats, then records one ``jax.profiler`` trace
with ``--reps`` calls of each, every call inside a host annotation. For the
last call of each it prints one JSON line: the host window, the device
span (first kernel start to last kernel end), the busy time (union of
kernels), the idle share of the span, the kernel time by class
(``KERNEL_CLASSES``) and by forward scope (embed, attn, mlp, head), and the
top kernels. It also times an 8192^3 bf16 matmul and a 1 GiB elementwise
copy on the same card as context for the rates. The trace (xplane) and a
JSON summary are written under ``--out``; the last line names the card.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

# Kernel classes, first match wins: (class, test on the kernel name).
KERNEL_CLASSES = (
    ("int8 GEMM, cuBLAS", lambda n: "i8i32" in n),
    ("bf16 GEMM, cuBLAS", lambda n: n.startswith("nvjet")
     or ("gemm" in n and "cublas" in n)),
    ("GEMM fusion, Triton", lambda n: n.startswith("gemm_fusion")),
    ("transpose", lambda n: "transpose" in n),
    ("memset/memcpy", lambda n: n.startswith(("Memset", "Memcpy"))),
    ("elementwise/reduce fusion", lambda n: True),
)
SCOPES = ("embed", "attn", "mlp", "head")


def kernel_class(name: str) -> str:
    return next(c for c, test in KERNEL_CLASSES if test(name))


def kernel_scope(stats: dict) -> str:
    """The forward's jax.named_scope a kernel ran under, where the trace
    names it ('unattributed' inside command buffers, which lose it)."""
    path = stats.get("name", "")
    for scope in SCOPES:
        if f"/{scope}" in path:
            return scope
    return "unattributed"


def summarize_window(window, kernels) -> dict:
    """One host window (start_ns, end_ns) and the device kernels
    [(name, start_ns, end_ns, stats)] that started inside it."""
    ws, we = window
    evs = sorted((k for k in kernels if ws <= k[1] <= we),
                 key=lambda k: k[1])
    busy, cur_s, cur_e = 0, None, None
    for _, s, e, _ in evs:
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0 if cur_e is None else cur_e - cur_s
    span = (max(e for _, _, e, _ in evs) - evs[0][1]) if evs else 0
    by_class, by_scope, by_name = (collections.Counter() for _ in range(3))
    for name, s, e, stats in evs:
        by_class[kernel_class(name)] += e - s
        by_scope[kernel_scope(stats)] += e - s
        by_name[name] += e - s
    us = lambda c: {k: v / 1e3 for k, v in c.most_common()}  # noqa: E731
    return {
        "window_us": (we - ws) / 1e3,
        "device_span_us": span / 1e3,
        "busy_us": busy / 1e3,
        "idle_share_of_span": 1.0 - busy / span if span else None,
        "kernel_sum_us": sum(e - s for _, s, e, _ in evs) / 1e3,
        "n_kernels": len(evs),
        "by_class_us": us(by_class),
        "by_scope_us": us(by_scope),
        "top_kernels_us": list(us(by_name).items())[:20],
    }


def read_trace(path: str, prefix: str = "fwd_"):
    """(host windows {annotation: [(start, end)]}, device kernels) of one
    xplane file."""
    pd = jax.profiler.ProfileData.from_file(path)
    windows, kernels = collections.defaultdict(list), []
    for plane in pd.planes:
        on_device = plane.name.startswith("/device:")
        for line in plane.lines:
            for ev in line.events:
                if ev.name.startswith(prefix):
                    windows[ev.name].append((ev.start_ns, ev.end_ns))
                elif on_device:
                    kernels.append((ev.name, ev.start_ns, ev.end_ns,
                                    {k: str(v) for k, v in ev.stats}))
    return windows, kernels


def _rate(fn, arg, reps: int = 10) -> float:
    jax.block_until_ready(fn(arg))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(arg)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="chiprun_out/trace")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"trace_forward.py needs a GPU; JAX found "
                         f"{dev.platform}")
    import chip_smoke as cs
    from quantized_vit_tpu.cli._common import enable_compile_cache
    from quantized_vit_tpu.serve import vit_int4_forward

    enable_compile_cache()
    card = cs.card_line().splitlines()[0]
    cfg = cs.vit_b16()
    arts = jax.device_put(cs.make_artifacts(cfg, 0), dev)
    x = jax.device_put(cs.make_patches(cfg, args.batch, 0), dev)
    runs = {f"fwd_b{b}_{fmt}": (arts[fmt], x[:b])
            for fmt in ("int8", "int4") for b in (args.batch, 1)}

    def forward(art, xb):
        return vit_int4_forward(art, xb, cfg, float_dtype=jnp.bfloat16,
                                images_layout="patches")

    for art, xb in runs.values():   # compile and warm up
        jax.block_until_ready(forward(art, xb))
        jax.block_until_ready(forward(art, xb))

    mm = jnp.ones((8192, 8192), jnp.bfloat16)
    copy = jnp.ones((256, 1024, 1024), jnp.float32)   # 1 GiB
    context = {
        "bf16_matmul_8192_tflops": 2 * 8192**3 / 1e12 / _rate(
            jax.jit(lambda a: a @ a), mm),
        "copy_1gib_gb_per_s_read_plus_write": 2 * copy.nbytes / 1e9 / _rate(
            jax.jit(lambda c: c * 2.0), copy),
    }
    del mm, copy

    os.makedirs(args.out, exist_ok=True)
    jax.profiler.start_trace(args.out)
    for key, (art, xb) in runs.items():
        for _ in range(args.reps):
            with jax.profiler.TraceAnnotation(key):
                jax.block_until_ready(forward(art, xb))
    jax.profiler.stop_trace()

    path = sorted(glob.glob(f"{args.out}/**/*.xplane.pb", recursive=True))[-1]
    windows, kernels = read_trace(path)
    summary = {"card": card, "device_kind": dev.device_kind,
               "context": context, "windows": {}}
    print(json.dumps(context))
    for key in runs:
        summary["windows"][key] = s = summarize_window(windows[key][-1],
                                                       kernels)
        print(json.dumps({key: {k: v for k, v in s.items()
                                if k != "top_kernels_us"}}))
        print(json.dumps({key + " top kernels": s["top_kernels_us"][:12]}))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"card (nvidia-smi name, power.limit): {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
