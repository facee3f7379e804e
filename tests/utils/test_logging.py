"""MetricsWriter + profiler helpers (utils/logging.py): TensorBoard events
when torch is present, JSONL mirror always, trace aggregation."""

import json
import os

import numpy as np
import pytest

from quantized_vit_tpu.utils.logging import (
    MetricsWriter,
    device_kernel_times,
    profile_trace,
)


def test_metrics_writer_jsonl_mirror(tmp_path):
    w = MetricsWriter(str(tmp_path), use_tensorboard=False)
    w.add_scalar("train/loss", 1.5, 0)
    w.add_scalars({"top1": 0.9, "skipme": "str"}, step=1, prefix="val/")
    w.close()
    lines = [json.loads(l) for l in
             open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert lines[0] == pytest.approx(
        {"tag": "train/loss", "value": 1.5, "step": 0,
         "ts": lines[0]["ts"]})
    assert lines[1]["tag"] == "val/top1"
    assert len(lines) == 2  # non-numeric scalar skipped


def test_metrics_writer_tensorboard_events(tmp_path):
    w = MetricsWriter(str(tmp_path), use_tensorboard=True)
    if not w.has_tensorboard:
        pytest.skip("torch tensorboard not available")
    w.add_scalar("x", 1.0, 0)
    w.close()
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path))


def test_profile_trace_captures_and_aggregates(tmp_path):
    import jax
    import jax.numpy as jnp

    with profile_trace(str(tmp_path)) as d:
        x = jnp.ones((128, 128))
        (x @ x).block_until_ready()
    # CPU-only run: a trace dir exists; kernel aggregation returns a dict
    # (possibly empty on CPU where no device pid is present)
    assert os.path.isdir(tmp_path)
    times = device_kernel_times(str(tmp_path))
    assert isinstance(times, dict)


def test_profile_trace_disabled_is_noop(tmp_path):
    target = tmp_path / "never"
    with profile_trace(str(target), enabled=False) as d:
        assert d is None
    assert not target.exists()
