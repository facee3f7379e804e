"""Continuous batcher: correctness under concurrency, bucketing, errors."""

import threading
import time

import numpy as np
import pytest

from quantized_vit_tpu.serve import ContinuousBatcher


def _echo_forward(batch):
    # output row = sum of input row; identifies which row each result is
    return batch.reshape(batch.shape[0], -1).sum(axis=1, keepdims=True)


def test_all_requests_resolve_with_correct_rows():
    with ContinuousBatcher(_echo_forward, max_batch=4,
                           max_delay_ms=5.0) as b:
        imgs = [np.full((2, 2), float(i)) for i in range(13)]
        futs = [b.submit(x) for x in imgs]
        for i, f in enumerate(futs):
            got = f.result(timeout=10)
            assert got[0] == pytest.approx(4.0 * i)
    assert b.stats["requests"] == 13
    assert b.stats["batches"] >= 4  # 13 requests over max_batch=4


def test_buckets_are_powers_of_two_capped():
    b = ContinuousBatcher(_echo_forward, max_batch=6)
    assert b.buckets == [1, 2, 4, 6]


def test_padding_goes_to_next_bucket():
    calls = []

    def spy_forward(batch):
        calls.append(batch.shape[0])
        return _echo_forward(batch)

    with ContinuousBatcher(spy_forward, max_batch=8,
                           max_delay_ms=1.0) as b:
        futs = [b.submit(np.ones((2, 2))) for _ in range(3)]
        for f in futs:
            f.result(timeout=10)
    # every executed batch is a bucket size
    assert all(c in (1, 2, 4, 8) for c in calls), calls


def test_concurrent_submitters_all_resolve():
    results = {}

    def client(cid, b):
        futs = [b.submit(np.full((2,), float(cid * 100 + i)))
                for i in range(5)]
        results[cid] = [f.result(timeout=10)[0] for f in futs]

    with ContinuousBatcher(_echo_forward, max_batch=8,
                           max_delay_ms=2.0) as b:
        threads = [threading.Thread(target=client, args=(c, b))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for cid, vals in results.items():
        assert vals == [pytest.approx(2.0 * (cid * 100 + i))
                        for i in range(5)]


def test_forward_error_propagates_to_futures():
    def bad_forward(batch):
        raise RuntimeError("device on fire")

    with ContinuousBatcher(bad_forward, max_batch=2,
                           max_delay_ms=1.0) as b:
        f = b.submit(np.ones((2,)))
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)


def test_vit_int4_artifact_through_batcher_matches_direct():
    import jax.numpy as jnp

    from quantized_vit_tpu.models.vit import ViTConfig
    from quantized_vit_tpu.serve import (random_vit_int4_artifact,
                                         vit_int4_forward)

    cfg = ViTConfig(img_size=16, patch_size=16, embed_dim=32, depth=1,
                    num_heads=2, num_classes=5)
    art = random_vit_int4_artifact(cfg, seed=0)

    def forward(images):
        return np.asarray(vit_int4_forward(
            art, jnp.asarray(images, jnp.float32), cfg))

    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((6, 16, 16, 3)).astype(np.float32)
    want = forward(imgs)

    with ContinuousBatcher(forward, max_batch=4, max_delay_ms=5.0) as b:
        futs = [b.submit(imgs[i]) for i in range(6)]
        got = np.stack([f.result(timeout=60) for f in futs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_backlog_forms_full_batches():
    """Regression: requests older than max_delay must still batch together
    — the age-based deadline only bounds waiting for FUTURE requests. (A
    256-request burst previously degenerated to size-1 batches at 28
    rps once the queue aged past the 5ms deadline.)"""
    import numpy as np

    from quantized_vit_tpu.serve import ContinuousBatcher

    calls = []

    def forward(images):
        calls.append(len(images))
        return np.zeros((len(images), 4), np.float32)

    b = ContinuousBatcher(forward, max_batch=8, max_delay_ms=1.0)
    x = np.zeros((4, 4, 3), np.float32)
    # enqueue a burst BEFORE starting the worker: everything is already
    # older than max_delay when collection begins
    futs = [b.submit(x) for _ in range(32)]
    import time

    time.sleep(0.05)
    with b:
        for f in futs:
            f.result(timeout=30)
    assert max(calls) == 8            # full batches formed
    assert calls.count(8) >= 3


def test_stop_rejects_pending_and_late_submits():
    """Futures never hang: requests still queued at stop() get an error,
    and submitting to a stopped batcher fails fast."""
    import numpy as np

    from quantized_vit_tpu.serve import ContinuousBatcher

    def forward(images):
        return np.zeros((len(images), 2), np.float32)

    b = ContinuousBatcher(forward, max_batch=4, max_delay_ms=1.0)
    x = np.zeros((2, 2, 3), np.float32)
    # never started: stop() must reject whatever was queued
    f1 = b.submit(x)
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        f1.result(timeout=5)
    f2 = b.submit(x)
    with pytest.raises(RuntimeError, match="stopped"):
        f2.result(timeout=5)


class _FakeAsyncDevice:
    """Models JAX async dispatch: the forward call costs ``host_cost``
    (synchronous trace/assembly share), returns immediately, and the result
    materializes ``device_latency`` later when np.asarray blocks on it."""

    def __init__(self, host_cost=0.01, device_latency=0.01):
        self.host_cost = host_cost
        self.device_latency = device_latency
        self._lock = threading.Lock()
        self._free_at = 0.0

    def __call__(self, images):
        time.sleep(self.host_cost)
        with self._lock:  # device executes batches in order
            start = max(time.monotonic(), self._free_at)
            self._free_at = start + self.device_latency
            ready_at = self._free_at
        out = images.sum(axis=tuple(range(1, images.ndim)))

        class Lazy:
            def __array__(self, dtype=None):
                now = time.monotonic()
                if ready_at > now:
                    time.sleep(ready_at - now)
                return np.asarray(out, dtype=dtype)

        return Lazy()


def test_dispatch_overlaps_device_execution():
    """Host assembly of batch N+1 overlaps device execution of batch N:
    with host_cost == device_latency the pipelined batcher must beat the
    serial (host+device) sum by well over 1.5x."""
    n_batches = 12
    host, dev = 0.010, 0.010
    serial = n_batches * (host + dev)
    imgs = [np.full((2, 2), float(i)) for i in range(4 * n_batches)]
    # Wall-clock assertion: best of 3 attempts, so transient CPU contention
    # (e.g. the rest of the suite running in parallel) cannot fail the test.
    best = float("inf")
    for _ in range(3):
        fake = _FakeAsyncDevice(host, dev)
        b = ContinuousBatcher(fake, max_batch=4, max_delay_ms=1.0)
        with b:
            t0 = time.monotonic()
            futs = [b.submit(im) for im in imgs]
            res = [f.result(timeout=30) for f in futs]
            dt = time.monotonic() - t0
        np.testing.assert_allclose(res, [im.sum() for im in imgs])
        best = min(best, dt)
        if best < serial / 1.5:
            break
    assert best < serial / 1.5, f"no overlap: {best:.3f}s vs serial {serial:.3f}s"


def test_multihost_frontend_balances_and_resolves():
    from quantized_vit_tpu.serve import MultiHostFrontend

    backends = [
        ContinuousBatcher(lambda x: x * (i + 1), max_batch=2,
                          max_delay_ms=1.0)
        for i in range(3)
    ]
    front = MultiHostFrontend(backends)
    with front:
        futs = [front.submit(np.full((2,), float(k))) for k in range(30)]
        res = [f.result(timeout=10) for f in futs]
    # every request resolved with ITS row times its backend's factor
    for k, r in enumerate(res):
        assert r[0] / k in (1.0, 2.0, 3.0) if k else True
    served = [b.stats["requests"] for b in backends]
    assert sum(served) == 30
    assert all(s > 0 for s in served), f"unbalanced routing: {served}"
