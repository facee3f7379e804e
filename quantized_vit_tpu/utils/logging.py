"""Observability: metric scalars + on-device profiler traces.

The reference logs train/val loss/acc, lr, top-1/5 and avg_wt_bit to
TensorBoard (train.py:272, 504-515) and has no performance profiler
(SURVEY.md §5). JAX equivalents:

- :class:`MetricsWriter` — scalar logging to TensorBoard event files when
  ``torch.utils.tensorboard`` is importable (torch is an allowed baked-in
  dependency), always mirrored to a plain ``metrics.jsonl`` so headless runs
  need no reader.
- :func:`profile_trace` — context manager around ``jax.profiler.trace``:
  captures a device trace viewable in TensorBoard's profile plugin /
  Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    """Scalar metrics -> TensorBoard events (if available) + JSONL."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    @property
    def has_tensorboard(self) -> bool:
        return self._tb is not None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self.add_scalar(f"{prefix}{k}", v, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Capture a jax.profiler device trace into ``log_dir`` (TensorBoard
    profile plugin format). No-op when disabled."""
    if not enabled:
        yield None
        return
    import jax

    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield log_dir


def device_kernel_times(trace_dir: str) -> Dict[str, float]:
    """Aggregate per-kernel device time (us) from a captured trace."""
    import collections
    import glob
    import gzip
    import re

    paths = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not paths:
        return {}
    with gzip.open(sorted(paths)[-1]) as f:
        tr = json.load(f)
    pids = {e["pid"]: e["args"].get("name", "") for e in tr["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev = {p for p, n in pids.items() if n.startswith("/device:")}
    durs: Dict[str, float] = collections.defaultdict(float)
    for e in tr["traceEvents"]:
        if (e.get("ph") == "X" and e.get("pid") in dev
                and not e["name"].startswith("jit_")):
            durs[re.sub(r"[.\d]+$", "", e["name"])] += e.get("dur", 0.0)
    return dict(durs)
