"""Test-set evaluation of a (possibly compressed) checkpoint.

Mirrors `QViT_with_GETA/RESULT_TEST.py:36-109`: load the model, run the
test split, report top-1/top-5, write a results file. Compressed subnets
reconstruct from the ViTConfig dict stored in the checkpoint meta (the
reference pickles the whole sliced torch module instead —
pruning_compression.py:385).
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp

from ._common import add_dataset_args, add_model_args, build_datasets, \
    build_model, load_params_any, set_seed


def vit_config_from_dict(d: dict):
    from ..models.layers import QuantConfig
    from ..models.vit import ViTConfig

    d = dict(d)
    q = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in d.pop("quant").items()}
    for k in ("heads_per_block", "hidden_per_block"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return ViTConfig(quant=QuantConfig(**q), **d)


def load_model_for_eval(args):
    """(model, params): either a fresh architecture from flags + checkpoint
    params, or a compressed subnet whose config rides in the meta."""
    from ..models.layers import QuantConfig
    from ..models.vit import VisionTransformer

    params, _, extra = load_params_any(args.checkpoint)
    if "subnet" in extra:
        cfg = vit_config_from_dict(extra["subnet"])
        return VisionTransformer(cfg), params
    model, _ = build_model(args, QuantConfig(enabled=not args.fp32))
    return model, params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT checkpoint evaluation")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint path prefix (from cli.train), or a "
                        "reference PyTorch .pt/.pth file (auto-converted)")
    p.add_argument("--fp32", action="store_true",
                   help="evaluate without quantizers")
    p.add_argument("--results", default="",
                   help="optional results txt path (RESULT_TEST.py:97-107)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)

    from ..utils import DataLoader, evaluate

    model, params = load_model_for_eval(args)
    _, test_ds = build_datasets(args)
    loader = DataLoader(test_ds, args.batch_size, pad_last=True)

    def apply_fn(p, x):
        return model.apply({"params": p}, x, deterministic=True)

    out = evaluate(apply_fn, params, loader)
    print(f"[eval] top1 {out['top1']:.4f} top5 {out['top5']:.4f} "
          f"loss {out['loss']:.4f} ({out['samples']} samples)")
    if args.results:
        os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)
        with open(args.results, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    from ._common import enable_compile_cache

    enable_compile_cache()
    main()
