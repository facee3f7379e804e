"""ctypes bindings for the C++ batch-prep engine + a prefetching loader.

The reference hides input-pipeline cost behind torch DataLoader worker
PROCESSES (train.py:278 num_workers). This runtime does the same
work in-process: the uint8 -> normalized-float conversion and batch gather
run in C++ (OpenMP, per-channel LUTs — utils/_native/batchprep.cc), and
:class:`PrefetchLoader` overlaps the next batch's host-side preparation
with the device step from a background thread. numpy fallbacks keep
everything working without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_SRC = os.path.join(_DIR, "batchprep.cc")
_SO = os.path.join(_DIR, "libqvtbatchprep.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    # compile to a per-pid temp name and rename (atomic on POSIX): another
    # process racing the build must never CDLL a half-written .so
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for cmd in (
        ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", _SRC, "-o", tmp],
        ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
    ):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            return True
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            continue
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO) and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.qvt_normalize_u8_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.qvt_gather_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ]
        if hasattr(lib, "qvt_patchify_f32"):
            lib.qvt_patchify_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
            ]
        _lib = lib
        return _lib


def native_prep_available() -> bool:
    return _load() is not None


def normalize_u8_batch(images_u8: np.ndarray, mean: np.ndarray,
                       std: np.ndarray) -> np.ndarray:
    """uint8 NHWC batch -> normalized float32 in one fused pass.

    Evaluates ``(x * (1/255) - mean) * (1/std)`` in f32 (the C++ path uses
    per-channel 256-entry LUTs holding exactly those values). Relative to a
    literal ``/255 ... /std`` evaluation the multiply-by-reciprocal form
    differs by <=1 ulp — far below the input quantizer's step.
    """
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    c = images_u8.shape[-1]
    # broadcast scalars BEFORE the native call: the C++ side indexes
    # mean[ch]/inv_std[ch] for ch < c unconditionally
    mean = np.ascontiguousarray(
        np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    inv_std = np.ascontiguousarray(
        np.broadcast_to(1.0 / np.asarray(std, np.float32), (c,)))
    lib = _load()
    if lib is None:
        return ((images_u8.astype(np.float32) * (1.0 / 255.0) - mean)
                * inv_std)
    out = np.empty(images_u8.shape, np.float32)
    n_pixels = images_u8.size // c
    lib.qvt_normalize_u8_to_f32(
        images_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_pixels, c,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        inv_std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Parallel ``src[idx]`` for 2-D-viewable float32 arrays (batch gather
    from an in-memory dataset)."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.asarray(idx, np.int64)
    # numpy-compatible semantics up front: negatives wrap, out-of-range
    # raises — the C++ gather dereferences unchecked
    idx = np.where(idx < 0, idx + len(src), idx)
    if idx.size and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(
            f"gather index out of range for first axis of size {len(src)}")
    idx = np.ascontiguousarray(idx)
    lib = _load()
    if lib is None:
        return src[idx]
    row_elems = int(np.prod(src.shape[1:]))
    out = np.empty((len(idx),) + src.shape[1:], np.float32)
    lib.qvt_gather_rows_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(idx), row_elems,
    )
    return out


def patchify_batch_u8(images: np.ndarray, patch: int) -> np.ndarray:
    """uint8 variant of :func:`patchify_batch` (the serving integer-input
    mode — vit_int4_forward ``input_scale``, 4x fewer host->device bytes
    than f32): same byte reorder, numpy path. The C++ kernel is f32-only;
    a uint8 batch is 4x smaller, so a second native symbol is not worth
    it."""
    images = np.ascontiguousarray(images, np.uint8)
    b, h, w, c = images.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} not divisible by patch {patch}")
    x = images.reshape(b, h // patch, patch, w // patch, patch * c)
    x = np.transpose(x, (0, 1, 3, 2, 4))
    return np.ascontiguousarray(
        x.reshape(b, (h // patch) * (w // patch), patch * patch * c))


def patchify_batch(images: np.ndarray, patch: int) -> np.ndarray:
    """NHWC f32 batch -> ViT patch layout [B, (H/P)*(W/P), P*P*C].

    A pure host-side byte reorder (the batch assembler writes these bytes
    anyway), so the device does no relayout: serving feeds
    ``vit_int4_forward(..., images_layout='patches')`` from here and the
    patch embed becomes an ordinary K=P*P*C quantized matmul.
    """
    images = np.ascontiguousarray(images, np.float32)
    b, h, w, c = images.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} not divisible by patch {patch}")
    lib = _load()
    if lib is None or not hasattr(lib, "qvt_patchify_f32"):
        x = images.reshape(b, h // patch, patch, w // patch, patch * c)
        x = np.transpose(x, (0, 1, 3, 2, 4))
        return np.ascontiguousarray(
            x.reshape(b, (h // patch) * (w // patch), patch * patch * c))
    out = np.empty((b, (h // patch) * (w // patch), patch * patch * c),
                   np.float32)
    lib.qvt_patchify_f32(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, h, w, c, patch,
    )
    return out


class PrefetchLoader:
    """Wrap any batch iterator; a background thread keeps ``depth`` batches
    prepared ahead so host-side input work overlaps the device step (the
    functional analogue of DataLoader(num_workers=...) without fork)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = int(depth)

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()
        err: list = []
        abandoned = threading.Event()

        def put(item) -> bool:
            # bounded put that notices consumer abandonment (break /
            # exception in the training loop) so the producer thread never
            # blocks forever holding prepared batches
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for item in self.loader:
                    if not put(item):
                        return
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                put(_END)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            abandoned.set()
