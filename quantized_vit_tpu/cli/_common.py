"""Shared CLI plumbing: compile cache, dataset flags, model builders,
seeding."""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set. Otherwise the cache goes to ``.jax_cache`` at
    the repository root: a fixed path, because the path is part of the
    cache key. Call before the first compilation of the process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def set_seed(seed: int):
    """train.py:254-259 (python/numpy; JAX keys derive from the same seed)."""
    import random

    random.seed(seed)
    np.random.seed(seed)


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "folder", "npz"],
                   help="synthetic: random data (smoke runs); folder: "
                        "class-per-subfolder image tree (read_split_data); "
                        "npz: {train,test}_{images,labels} arrays")
    p.add_argument("--data-path", default="", help="dataset root / npz file")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--synthetic-samples", type=int, default=64)


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="vit_b16",
                   choices=["vit_b16", "vit_b32", "vit_l16", "vit_tiny_test",
                            "vit_small_test"],
                   help="vit_tiny_test is a 2-block toy for smoke runs; "
                        "vit_small_test a 4-block patch-8 model for the "
                        "accuracy rehearsal")
    p.add_argument("--weights", default="",
                   help="checkpoint dir to initialize from (opt/checkpoint)")


def build_model(args, quant):
    """Model + config from --model (train.py:232-252 Model())."""
    from ..models.vit import ViTConfig, VisionTransformer

    if args.model == "vit_b16":
        cfg = ViTConfig(img_size=args.img_size, patch_size=16, embed_dim=768,
                        depth=12, num_heads=12,
                        num_classes=args.num_classes, quant=quant)
    elif args.model == "vit_b32":
        cfg = ViTConfig(img_size=args.img_size, patch_size=32, embed_dim=768,
                        depth=12, num_heads=12,
                        num_classes=args.num_classes, quant=quant)
    elif args.model == "vit_l16":
        cfg = ViTConfig(img_size=args.img_size, patch_size=16, embed_dim=1024,
                        depth=24, num_heads=16,
                        num_classes=args.num_classes, quant=quant)
    elif args.model == "vit_small_test":
        cfg = ViTConfig(img_size=args.img_size, patch_size=8, embed_dim=64,
                        depth=4, num_heads=4,
                        num_classes=args.num_classes, quant=quant)
    else:  # vit_tiny_test
        cfg = ViTConfig(img_size=args.img_size, patch_size=16, embed_dim=64,
                        depth=2, num_heads=2,
                        num_classes=args.num_classes, quant=quant)
    return VisionTransformer(cfg), cfg


def load_params_any(path: str) -> Tuple:
    """(params, step, extra) from either a native checkpoint prefix or a
    reference PyTorch ``.pt``/``.pth`` file (interop.torch_import).

    Torch payloads are auto-classified: ``layers.{i}.*`` keys mean the
    UltraNet Sequential (mymodel.py:71-124) — its BN stats land in
    ``extra['batch_stats']``; anything else converts as a ViT state dict
    (plain or QAT-quantized).
    """
    if path.endswith((".pt", ".pth")):
        from ..interop import (
            load_torch_checkpoint,
            ultranet_params_from_torch,
            vit_params_from_torch,
        )

        sd = load_torch_checkpoint(path)
        if any(k.startswith("layers.") for k in sd):
            params, stats = ultranet_params_from_torch(sd)
            return params, 0, {"batch_stats": stats}
        return vit_params_from_torch(sd, strict=False), 0, {}
    from ..opt.checkpoint import load_checkpoint

    return load_checkpoint(path)


def build_datasets(args) -> Tuple:
    """(train_ds, val_ds) per --dataset."""
    from ..utils import ArrayDataset, ImageFolderDataset, read_split_data

    if args.dataset == "synthetic":
        rng = np.random.default_rng(0)
        n = args.synthetic_samples
        s = args.img_size

        def mk(k):
            return ArrayDataset(
                rng.standard_normal((k, s, s, 3)).astype(np.float32),
                rng.integers(0, args.num_classes, k))

        return mk(n), mk(max(n // 4, args.batch_size))
    if args.dataset == "npz":
        with np.load(args.data_path) as z:
            return (ArrayDataset(z["train_images"], z["train_labels"]),
                    ArrayDataset(z["test_images"], z["test_labels"]))
    tp, tl, vp, vl = read_split_data(args.data_path)
    # fused native u8->normalized-f32 batch prep (train.py:227-231 uses
    # Normalize(0.5, 0.5, 0.5) for CIFAR-style drivers)
    norm = (np.full(3, 0.5, np.float32), np.full(3, 0.5, np.float32))
    return (ImageFolderDataset(tp, tl, img_size=args.img_size,
                               normalize=norm),
            ImageFolderDataset(vp, vl, img_size=args.img_size,
                               normalize=norm))
