"""Artifact export driver.

Replaces the reference's two-script FPGA flow (`python torch_export.py &&
python ultranet_param_gen.py`, 4-bit quantization/readme.md:1-2) with one
command per target:

  python -m quantized_vit_tpu.cli.export ultranet --checkpoint C --out D
  python -m quantized_vit_tpu.cli.export vit      --checkpoint C --out D
  python -m quantized_vit_tpu.cli.export hls      --checkpoint C --out D
  python -m quantized_vit_tpu.cli.export refnpz   --checkpoint C --out D

ultranet: flax checkpoint -> integer (kernel_int, inc, bias) artifact
          (artifact.ultranet; quantization.py:24-89 math).
vit:      trained fake-quant checkpoint -> packed-INT4 serving artifact
          (serve.export_vit_int4 + artifact.vit).
hls:      flax checkpoint -> FPGA C++ headers param.h/config.h
          (artifact.hls; exact parity with qnn_mem_process.py).
refnpz:   flax checkpoint -> reference-format ultranet_4w4a.npz +
          config.json (interop.npz_export; torch_export.py flow), so the
          reference's own downstream tooling consumes our checkpoints.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from ._common import add_model_args, build_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT artifact export")
    sub = p.add_subparsers(dest="target", required=True)

    pu = sub.add_parser("ultranet")
    pu.add_argument("--checkpoint", required=True,
                    help="checkpoint prefix with params+batch_stats "
                         "(stats under key 'batch_stats' in extra), or the "
                         "reference ultranet_4w4a.pt (torch_export.py:12)")
    pu.add_argument("--out", required=True)
    pu.add_argument("--w-bit", type=int, default=4)
    pu.add_argument("--a-bit", type=int, default=4)
    pu.add_argument("--l-shift", type=int, default=8)

    for name in ("hls", "refnpz"):
        ph = sub.add_parser(name)
        ph.add_argument("--checkpoint", required=True)
        ph.add_argument("--out", required=True)
        if name == "hls":
            ph.add_argument("--w-bit", type=int, default=4)
            ph.add_argument("--a-bit", type=int, default=4)
            ph.add_argument("--l-shift", type=int, default=8)

    pv = sub.add_parser("vit")
    add_model_args(pv)
    pv.add_argument("--checkpoint", required=True)
    pv.add_argument("--out", required=True)
    pv.add_argument("--img-size", type=int, default=224)
    pv.add_argument("--num-classes", type=int, default=10)

    pt = sub.add_parser(
        "torch",
        help="ViT checkpoint (full or GETA-compressed) -> reference-style "
             "torch state dict (.pt) + architecture JSON — the interchange "
             "format for a model leaving the JAX world (the reference "
             "pickles the sliced torch module, pruning_compression.py:385; "
             "a state dict + config is the same information without the "
             "pickle-code coupling)")
    add_model_args(pt)
    pt.add_argument("--checkpoint", required=True)
    pt.add_argument("--out", required=True,
                    help="output directory (model.pt + arch.json)")
    pt.add_argument("--img-size", type=int, default=224)
    pt.add_argument("--num-classes", type=int, default=10)

    po = sub.add_parser(
        "onnx",
        help="ViT checkpoint (full or GETA-compressed) -> ONNX graph of "
             "the dense float model via a reference-shaped torch module "
             "(pruning_compression.py:374-391's onnx branch). Requires "
             "the 'onnx' package at runtime; --bake-quant folds the "
             "trained weight-quant levels into the float weights first")
    add_model_args(po)
    po.add_argument("--checkpoint", required=True)
    po.add_argument("--out", required=True, help="output .onnx path")
    po.add_argument("--img-size", type=int, default=224)
    po.add_argument("--num-classes", type=int, default=10)
    po.add_argument("--bake-quant", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ._common import load_params_any

    if args.target == "ultranet":
        from ..artifact import UltraNetExportConfig, save_ultranet_artifact

        params, _, extra = load_params_any(args.checkpoint)
        stats = extra.get("batch_stats")
        if stats is None:
            raise SystemExit(
                "checkpoint lacks batch_stats in extra; re-save with "
                "save_checkpoint(..., extra={'batch_stats': stats})")
        exp = UltraNetExportConfig(w_bit=args.w_bit, a_bit=args.a_bit,
                                   l_shift=args.l_shift)
        out = save_ultranet_artifact(args.out, params, stats, exp)
        print(f"[export] ultranet integer artifact -> {out}")
        return out

    if args.target in ("hls", "refnpz"):
        params, _, extra = load_params_any(args.checkpoint)
        stats = extra.get("batch_stats")
        if stats is None:
            raise SystemExit(
                "checkpoint lacks batch_stats in extra; re-save with "
                "save_checkpoint(..., extra={'batch_stats': stats})")
        if args.target == "hls":
            from ..artifact import UltraNetExportConfig
            from ..artifact.hls import export_ultranet_hls

            exp = UltraNetExportConfig(w_bit=args.w_bit, a_bit=args.a_bit,
                                       l_shift=args.l_shift)
            export_ultranet_hls(params, stats, args.out, exp)
            print(f"[export] HLS headers (param.h, config.h) -> {args.out}")
            return args.out
        from ..interop import export_reference_ultranet

        npz_path, cfg_path = export_reference_ultranet(params, stats,
                                                       args.out)
        print(f"[export] reference npz -> {npz_path}, config -> {cfg_path}")
        return args.out

    if args.target == "onnx":
        import dataclasses

        from ..cli.eval import vit_config_from_dict
        from ..interop import vit_params_to_torch
        from ..interop.torch_model import (bake_weight_quant, build_torch_vit,
                                           export_onnx, load_interchange)
        from ..models.layers import QuantConfig

        params, _, extra = load_params_any(args.checkpoint)
        if "subnet" in extra:
            cfg = vit_config_from_dict(extra["subnet"])
        else:
            _, cfg = build_model(args, QuantConfig(enabled=True))
        if args.bake_quant:
            params = bake_weight_quant(params, cfg)
        model = build_torch_vit(dataclasses.asdict(cfg))
        load_interchange(model, vit_params_to_torch(params))
        out = export_onnx(args.out, model, cfg.img_size, cfg.in_channels)
        print(f"[export] onnx graph -> {out}")
        return out

    if args.target == "torch":
        import dataclasses
        import json
        import os

        from ..cli.eval import vit_config_from_dict
        from ..interop import vit_params_to_torch
        from ..models.layers import QuantConfig

        params, _, extra = load_params_any(args.checkpoint)
        if "subnet" in extra:
            cfg = vit_config_from_dict(extra["subnet"])
        else:
            _, cfg = build_model(args, QuantConfig(enabled=True))
        sd = vit_params_to_torch(params)
        os.makedirs(args.out, exist_ok=True)
        pt_path = os.path.join(args.out, "model.pt")
        try:
            import torch

            torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
                       pt_path)
        except ImportError:  # keep the export usable without torch
            pt_path = os.path.join(args.out, "model.npz")
            import numpy as np

            np.savez(pt_path, **sd)
            print("[export] WARNING: torch unavailable — wrote a numpy "
                  f"archive ({pt_path}) instead of model.pt; downstream "
                  "torch consumers must np.load it and build tensors "
                  "themselves (ADVICE r2 #3)")
        arch = dataclasses.asdict(cfg)  # recurses into the quant dataclass
        with open(os.path.join(args.out, "arch.json"), "w") as f:
            json.dump(arch, f, indent=1)
        kind = ("torch state dict" if pt_path.endswith(".pt")
                else "numpy state-dict archive (torch fallback)")
        print(f"[export] {kind} -> {pt_path}, arch.json alongside")
        return args.out

    from ..artifact import save_vit_int4_artifact
    from ..cli.eval import vit_config_from_dict
    from ..models.layers import QuantConfig
    from ..serve import export_vit_int4

    params, _, extra = load_params_any(args.checkpoint)
    if "subnet" in extra:
        cfg = vit_config_from_dict(extra["subnet"])
    else:
        _, cfg = build_model(args, QuantConfig(enabled=True))
    art = export_vit_int4(cfg, params)
    out = save_vit_int4_artifact(args.out, art, cfg)
    print(f"[export] vit int4 artifact -> {out}")
    return out


if __name__ == "__main__":
    from ._common import enable_compile_cache

    enable_compile_cache()
    main()
