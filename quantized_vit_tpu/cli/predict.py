"""Single-image prediction (QViT_with_GETA/predict.py).

Loads a checkpoint (full or compressed — see cli.eval), preprocesses one
image, prints softmax top-k with class names from an optional json index
(predict.py:29-41 class_indices).
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from ._common import add_model_args
from .eval import load_model_for_eval


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT single-image prediction")
    add_model_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--class-index", default="",
                   help="json {idx: name} (predict.py class_indices.json)")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--fp32", action="store_true")
    return p.parse_args(argv)


def load_image(path: str, img_size: int) -> np.ndarray:
    from PIL import Image

    from ..utils.data import normalize_image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((img_size, img_size), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return normalize_image(x)[None]


def main(argv=None):
    args = parse_args(argv)
    model, params = load_model_for_eval(args)
    x = jnp.asarray(load_image(args.image, args.img_size))

    logits = model.apply({"params": params}, x, deterministic=True)
    probs = np.asarray(jax.nn.softmax(logits[0]))
    names = {}
    if args.class_index:
        with open(args.class_index) as f:
            names = {int(k): v for k, v in json.load(f).items()}
    order = np.argsort(-probs)[: args.topk]
    for i in order:
        print(f"class: {names.get(int(i), int(i)):<20} "
              f"prob: {probs[i]:.4f}")
    return [(int(i), float(probs[i])) for i in order]


if __name__ == "__main__":
    from ._common import enable_compile_cache

    enable_compile_cache()
    main()
