"""Continuous batching for single-image inference requests.

No reference analogue (the reference only has batch eval scripts —
RESULT_TEST.py); this is BASELINE.md's serving requirement. Design
points:

- **Bucketed batch shapes.** XLA compiles one executable per input shape, so
  the scheduler pads each flush to the smallest power-of-two bucket ≤
  ``max_batch``. After warmup every flush hits a cached executable — no
  recompiles mid-serving.
- **Flush policy.** A flush happens when ``max_batch`` requests are waiting
  (a full batch) or the oldest request has waited ``max_delay_ms``
  (latency bound). One dispatcher thread owns the device; requests resolve
  through per-request futures.
- **Host/device overlap.** JAX dispatch is asynchronous: ``forward_fn``
  returns a future-backed Array immediately and only ``np.asarray`` blocks.
  The dispatcher therefore only collects, assembles, and DISPATCHES each
  batch, handing the un-materialized result to a separate completion
  thread — host assembly of batch N+1 overlaps device execution of batch
  N. ``max_in_flight`` bounds the dispatch queue (backpressure) so device
  memory holds a fixed number of outstanding batches.
- **Sharded serving.** The forward closure may capture GSPMD-sharded
  weights (artifact.vit.load_vit_int4_artifact with a mesh); the batch
  enters replicated (or data-sharded by the caller's in_sharding) and XLA
  inserts the collectives. For multi-HOST serving see
  :class:`MultiHostFrontend`.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np


def _buckets_upto(max_batch: int) -> List[int]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


class ContinuousBatcher:
    """Batches concurrent single-image requests into bucketed device calls.

    forward_fn: [B, ...] batch -> [B, ...] outputs (jitted outside).
    """

    def __init__(self, forward_fn: Callable, max_batch: int = 8,
                 max_delay_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 max_in_flight: int = 2):
        self.forward_fn = forward_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = max_delay_ms / 1e3
        self.buckets = sorted(buckets) if buckets else _buckets_upto(max_batch)
        if self.buckets[-1] < self.max_batch:
            self.buckets.append(self.max_batch)
        self._q: "queue.Queue" = queue.Queue()
        # (device_result, pending) pairs awaiting materialization; bounded
        # so at most max_in_flight batches are outstanding on the device
        self._done_q: "queue.Queue" = queue.Queue(maxsize=max(1, max_in_flight))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "padded": 0,
                      "batch_hist": {}}

    # ------------------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._thread.start()
        self._completer.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._completer is not None:
            self._done_q.put(None)  # sentinel after dispatcher exit
            self._completer.join(timeout=10)
            self._completer = None
        # reject anything that raced past the dispatcher's exit — a Future
        # left on a dead queue would block its caller forever
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one sample (no batch dim). Resolves to its output row.
        Submitting to a stopped batcher resolves the Future with an error
        instead of leaving it pending forever."""
        fut: Future = Future()
        if self._stop.is_set() and self._thread is None:
            fut.set_exception(RuntimeError("batcher stopped"))
            return fut
        self._q.put((image, fut, time.monotonic()))
        self.stats["requests"] += 1
        return fut

    def queue_depth(self) -> int:
        """Queued (not yet dispatched) requests — the router's load signal.
        Part of the backend duck-type shared with serve.rpc.RpcBackendStub."""
        return self._q.qsize()

    def warmup(self, example: np.ndarray):
        """Pre-compile every bucket shape so serving never hits a compile."""
        for b in self.buckets:
            batch = np.broadcast_to(example[None], (b, *example.shape))
            np.asarray(self.forward_fn(np.ascontiguousarray(batch)))

    # ------------------------------------------------------------------

    def _collect(self) -> List:
        """Block for the first request, then drain until a flush condition.

        Already-queued requests are drained unconditionally (a backlog older
        than max_delay must still form FULL batches — otherwise a burst
        degenerates into size-1 batches the moment the queue ages past the
        deadline); max_delay only bounds the wait for requests that haven't
        arrived yet.
        """
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        pending = [first]
        deadline = first[2] + self.max_delay_s
        while len(pending) < self.max_batch:
            try:
                pending.append(self._q.get_nowait())
                continue
            except queue.Empty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                pending.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return pending

    def _run(self):
        """Dispatcher: collect -> assemble -> dispatch (async), never blocks
        on device results — batch N+1's host work overlaps batch N's
        device execution."""
        while not self._stop.is_set() or not self._q.empty():
            pending = self._collect()
            if not pending:
                continue
            n = len(pending)
            bucket = next(b for b in self.buckets if b >= n)
            images = np.stack([p[0] for p in pending])
            if bucket != n:
                pad = np.repeat(images[:1], bucket - n, axis=0)
                images = np.concatenate([images, pad], axis=0)
                self.stats["padded"] += bucket - n
            try:
                out = self.forward_fn(images)  # async dispatch
            except Exception as e:  # dispatch-time failure (shape, compile)
                for _, fut, _ in pending:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._done_q.put((out, pending))  # blocks at max_in_flight
            self.stats["batches"] += 1
            self.stats["batch_hist"][bucket] = (
                self.stats["batch_hist"].get(bucket, 0) + 1)

    def _complete_loop(self):
        """Completer: materialize device results and resolve futures."""
        while True:
            item = self._done_q.get()
            if item is None:
                return
            out, pending = item
            try:
                arr = np.asarray(out)  # blocks until the device finishes
                for i, (_, fut, _) in enumerate(pending):
                    fut.set_result(arr[i])
            except Exception as e:  # device-side failure surfaces here
                for _, fut, _ in pending:
                    if not fut.done():
                        fut.set_exception(e)


class MultiHostFrontend:
    """Request fan-out across multiple serving backends (hosts/chips).

    Data-parallel serving scales by sharding REQUESTS, not tensors: each
    backend owns its replica of the weights and its own
    :class:`ContinuousBatcher`; no inter-backend collective exists. This front-end routes each request to the
    least-loaded backend (by ``queue_depth()``), falling back to round
    robin on ties. Backends are anything carrying the batcher duck-type
    (``start/stop/submit/stats/queue_depth``): in-process
    :class:`ContinuousBatcher` instances OR :class:`~.rpc.RpcBackendStub`
    clients for per-host serving processes (tests/serve/test_rpc.py
    drives a real 2-process serve through this seam).
    """

    def __init__(self, backends: Sequence["ContinuousBatcher"]):
        if not backends:
            raise ValueError("need at least one backend")
        self.backends = list(backends)
        self._rr = 0
        self._lock = threading.Lock()

    def start(self):
        for b in self.backends:
            b.start()
        return self

    def stop(self):
        for b in self.backends:
            b.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def submit(self, image: np.ndarray) -> Future:
        with self._lock:
            loads = [b.queue_depth() for b in self.backends]
            lo = min(loads)
            # least-loaded; round-robin among equally loaded backends
            candidates = [i for i, v in enumerate(loads) if v == lo]
            pick = candidates[self._rr % len(candidates)]
            self._rr += 1
        return self.backends[pick].submit(image)

    @property
    def stats(self):
        return {i: b.stats for i, b in enumerate(self.backends)}
