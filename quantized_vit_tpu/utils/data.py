"""Data pipeline: folder-of-images dataset + statically-shaped batch loader.

Re-design of `QViT_with_GETA/my_dataset.py:6-50` (MyDataSet: PIL load, RGB
check, stack collate) and `utils.py:15-81` (read_split_data folder splitter)
for jit feeding: batches are numpy NHWC float32 with a FIXED batch size —
the trailing partial batch is either dropped or padded (padded entries carry
label -1 and a validity mask) so jit never sees a new shape and never
recompiles mid-epoch.

No torch DataLoader workers: decode happens inline (PIL) or ahead-of-time
into an in-memory array. For ImageNet-scale input pipelines, wrap this with
your own prefetch thread; the loader itself is deliberately simple and
dependency-free.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(x: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """[0,1] float image (H,W,3) -> normalized, matching the reference's
    transforms.Normalize(0.5,0.5,0.5) or ImageNet stats per driver config."""
    return (x - mean) / std


def read_split_data(root: str, val_rate: float = 0.2, seed: int = 0
                    ) -> Tuple[List[str], List[int], List[str], List[int]]:
    """Split a class-per-subfolder image tree into train/val lists
    (utils.py:15-81). Returns (train_paths, train_labels, val_paths,
    val_labels); class indices follow sorted(subfolder names)."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"dataset root {root} does not exist")
    classes = sorted(
        c for c in os.listdir(root) if os.path.isdir(os.path.join(root, c))
    )
    class_idx = {c: i for i, c in enumerate(classes)}
    rng = random.Random(seed)
    exts = {".jpg", ".jpeg", ".png", ".bmp"}

    train_paths: List[str] = []
    train_labels: List[int] = []
    val_paths: List[str] = []
    val_labels: List[int] = []
    for c in classes:
        cdir = os.path.join(root, c)
        imgs = sorted(
            os.path.join(cdir, f) for f in os.listdir(cdir)
            if os.path.splitext(f)[1].lower() in exts
        )
        val_set = set(rng.sample(imgs, k=int(len(imgs) * val_rate)))
        for p in imgs:
            if p in val_set:
                val_paths.append(p)
                val_labels.append(class_idx[c])
            else:
                train_paths.append(p)
                train_labels.append(class_idx[c])
    return train_paths, train_labels, val_paths, val_labels


class ArrayDataset:
    """In-memory dataset over (images NHWC float32, labels int) arrays."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert len(images) == len(labels)
        self.images = np.asarray(images)
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.images)

    def get(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.images.dtype == np.float32:
            from .native_prep import gather_rows

            return gather_rows(self.images, idx), self.labels[idx]
        return self.images[idx], self.labels[idx]


class ImageFolderDataset:
    """Path-list dataset decoding with PIL at access time (my_dataset.py:6-50).

    Non-RGB files raise ValueError like the reference. ``transform`` maps a
    float32 [0,1] HWC array to the final HWC array (resize/crop happen in
    PIL before conversion via ``img_size``).
    """

    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 img_size: int = 224,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 normalize: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        assert len(paths) == len(labels)
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.img_size = img_size
        self.transform = transform
        # (mean, std): decode stays uint8 and the whole batch normalizes in
        # one fused native pass (utils/native_prep.py) — the C++ analogue of
        # the reference's DataLoader-worker transforms (train.py:278)
        self.normalize = normalize

    def __len__(self):
        return len(self.paths)

    def _decode_u8(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path)
        if img.mode != "RGB":
            raise ValueError(f"image: {path} isn't RGB mode.")
        img = img.resize((self.img_size, self.img_size), Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def _load(self, path: str) -> np.ndarray:
        x = self._decode_u8(path).astype(np.float32) / 255.0
        if self.transform is not None:
            x = self.transform(x)
        return x

    def get(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.normalize is not None and self.transform is None:
            from .native_prep import normalize_u8_batch

            xs_u8 = np.stack([self._decode_u8(self.paths[i]) for i in idx])
            return (normalize_u8_batch(xs_u8, *self.normalize),
                    self.labels[idx])
        xs = np.stack([self._load(self.paths[i]) for i in idx])
        return xs, self.labels[idx]


class DataLoader:
    """Static-shape batch iterator.

    ``pad_last=False`` drops the trailing partial batch (torch drop_last);
    ``pad_last=True`` repeats index 0 to fill it and yields a boolean
    validity mask so eval can still count every sample without causing an
    XLA recompile.
    Yields (images, labels, mask) float32/int32/bool numpy arrays.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, pad_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_last = pad_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.pad_last:
            return (n + self.batch_size - 1) // self.batch_size
        return n // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        stop = n if self.pad_last else (n // bs) * bs
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            mask = np.ones(bs, bool)
            if len(idx) < bs:
                pad = bs - len(idx)
                mask[len(idx):] = False
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            images, labels = self.dataset.get(idx)
            yield images.astype(np.float32), labels, mask
