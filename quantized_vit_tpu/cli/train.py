"""Training driver: ViT QAT + joint structured pruning with GETA.

Mirrors `QViT_with_GETA/train.py:261-701` end-to-end: build loaders, wrap
the ViT with learned-scale quantizers, build the OTO dependency groups, mark
patch_embed/pos_embed/head unprunable, derive the projection/pruning
schedule from the epoch budget (train.py:370-387), train with cosine LR,
then construct the compressed subnet and report full-vs-compressed
MACs/BOPs/params/bits (train.py:534-617).
"""

from __future__ import annotations

import argparse
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from ._common import add_dataset_args, add_model_args, build_datasets, \
    build_model, set_seed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT GETA training")
    add_dataset_args(p)
    add_model_args(p)
    # optimizer (train.py:621-700 flags)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lrf", type=float, default=0.01,
                   help="final lr fraction for the cosine schedule")
    p.add_argument("--lr-quant", type=float, default=1e-3)
    p.add_argument("--variant", default="adam",
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--target-group-sparsity", type=float, default=0.5)
    p.add_argument("--group-divisible", type=int, default=1)
    # projection / pruning schedule (train.py:370-410)
    p.add_argument("--projection-start-epochs", type=float, default=1.0)
    p.add_argument("--projection-epochs", type=float, default=2.0)
    p.add_argument("--projection-periods", type=int, default=6)
    p.add_argument("--pruning-epochs", type=float, default=1.0)
    p.add_argument("--pruning-periods", type=int, default=5)
    p.add_argument("--bit-reduction", type=float, default=4.0)
    p.add_argument("--min-bit", type=float, default=4.0)
    p.add_argument("--max-bit", type=float, default=32.0)
    # loss config (utils.py)
    p.add_argument("--mix-up", action="store_true")
    p.add_argument("--label-smooth", action="store_true")
    p.add_argument("--use-kd", action="store_true")
    p.add_argument("--kd-alpha", type=float, default=0.5)
    p.add_argument("--kd-temperature", type=float, default=4.0)
    p.add_argument("--use-group-lasso", action="store_true")
    p.add_argument("--group-lasso-lambda", type=float, default=1e-4)
    p.add_argument("--gl-start-epoch", type=int, default=0)
    # misc
    p.add_argument("--matmul-dtype", default=None,
                   choices=[None, "bfloat16"],
                   help="mixed-precision QAT: dense/conv/attention dots "
                        "in bf16 with f32 accumulation, quantizer math "
                        "stays f32")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-dir", default="runs/train")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="disable TensorBoard event files (JSONL still kept)")
    p.add_argument("--profile-epoch", type=int, default=-1,
                   help="capture a jax.profiler device trace of this epoch")
    p.add_argument("--save-freq", type=int, default=0,
                   help="save a resumable checkpoint every N epochs (0=off)")
    p.add_argument("--resume", default="",
                   help="checkpoint dir to resume optimizer+params from")
    return p.parse_args(argv)


def cosine_lr(epoch: int, epochs: int, lr: float, lrf: float) -> float:
    """train.py:436-437 LambdaLR."""
    return lr * (((1 + math.cos(epoch * math.pi / epochs)) / 2)
                 * (1 - lrf) + lrf)


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)

    import flax

    from ..graph import OTO
    from ..models import QuantConfig, init_quant_params_tree
    from ..opt.checkpoint import load_checkpoint, save_checkpoint
    from ..utils import (ArrayDataset, DataLoader, PrefetchLoader, TrainLoop,
                         evaluate)

    train_ds, val_ds = build_datasets(args)
    # background-thread prefetch overlaps native batch prep with the device
    # step (the reference's DataLoader num_workers, train.py:278)
    train_loader = PrefetchLoader(DataLoader(
        train_ds, args.batch_size, shuffle=True, seed=args.seed))
    val_loader = PrefetchLoader(DataLoader(val_ds, args.batch_size,
                                           pad_last=True))
    steps_per_epoch = max(len(train_loader), 1)

    # model wrapped with learned-scale quantizers at 32 bits
    # (model_to_quantize_model(num_bits=32, ...) — train.py:247-250)
    model, cfg = build_model(
        args, QuantConfig(enabled=True,
                          matmul_dtype=getattr(args, "matmul_dtype", None)))
    x0 = jnp.zeros((1, args.img_size, args.img_size, 3), jnp.float32)
    params = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(args.seed), x0)["params"])
    params = init_quant_params_tree(params, init_bits=args.max_bit)
    if args.weights:
        params, _, _ = load_checkpoint(args.weights)
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    print(f"[train] model {args.model}: {n_params/1e6:.1f}M params, "
          f"{steps_per_epoch} steps/epoch")

    # dependency groups + unprunable marking (train.py:333-341)
    oto = OTO(model, params)
    oto.mark_unprunable_by_param_names(
        ["patch_embed", "pos_embed", "cls_token", "head"])

    # schedule in steps (train.py:370-410)
    start_proj = int(args.projection_start_epochs * steps_per_epoch)
    proj_steps = max(int(args.projection_epochs * steps_per_epoch), 1)
    prune_start = start_proj + proj_steps
    prune_steps = max(int(args.pruning_epochs * steps_per_epoch), 1)
    opt = oto.geta(
        lr=args.lr, lr_quant=args.lr_quant, variant=args.variant,
        weight_decay=args.weight_decay,
        target_group_sparsity=args.target_group_sparsity,
        group_divisible=args.group_divisible,
        start_projection_step=start_proj,
        projection_steps=proj_steps,
        projection_periods=args.projection_periods,
        start_pruning_step=prune_start,
        pruning_steps=prune_steps,
        pruning_periods=args.pruning_periods,
        bit_reduction=args.bit_reduction,
        min_bit_wt=args.min_bit, max_bit_wt=args.max_bit,
        min_bit_act=args.min_bit, max_bit_act=args.max_bit,
    )
    if args.resume:
        params, opt_state, _ = load_checkpoint(args.resume)
        if opt_state:
            opt.load_state_dict(opt_state)
        print(f"[train] resumed from {args.resume} at step {opt.num_steps}")

    def apply_fn(p, x, step_rng):
        return model.apply({"params": p}, x, deterministic=False,
                           rngs={"dropout": step_rng})

    teacher_fn = None
    if args.use_kd:
        # self-distillation from the frozen fp32 init (train_geta_test.py
        # uses the pre-quantization teacher; here: same arch, quant off)
        t_model, _ = build_model(args, QuantConfig.off())
        t_params = flax.core.unfreeze(
            t_model.init(jax.random.PRNGKey(args.seed), x0)["params"])

        def teacher_fn(x):
            return t_model.apply({"params": t_params}, x,
                                 deterministic=True)

    loop = TrainLoop(
        apply_fn=apply_fn, optimizer=opt, num_classes=args.num_classes,
        mix_up=args.mix_up, label_smooth=args.label_smooth,
        teacher_fn=teacher_fn, kd_alpha=args.kd_alpha if args.use_kd else 0.0,
        kd_temperature=args.kd_temperature,
        use_group_lasso=args.use_group_lasso,
        group_lasso_lambda=args.group_lasso_lambda,
        gl_start_epoch=args.gl_start_epoch,
    )

    def eval_apply(p, x):
        return model.apply({"params": p}, x, deterministic=True)

    from ..utils.logging import MetricsWriter, profile_trace

    writer = MetricsWriter(os.path.join(args.out_dir, "tb"),
                           use_tensorboard=not args.no_tensorboard)
    history = []
    best_top1 = -1.0
    rng = jax.random.PRNGKey(args.seed)
    for epoch in range(args.epochs):
        opt.set_lr(cosine_lr(epoch, args.epochs, args.lr, args.lrf))
        rng, erng = jax.random.split(rng)
        with profile_trace(os.path.join(args.out_dir, "profile"),
                           enabled=epoch == args.profile_epoch):
            params, tm = loop.train_one_epoch(params, train_loader, epoch,
                                              erng)
        em = evaluate(eval_apply, params, val_loader)
        sm = opt.compute_metrics(params)
        avg_bits = oto.compute_average_bit_width(params)
        rec = {"epoch": epoch, "lr": opt.cfg.lr, **tm,
               "val_top1": em["top1"], "val_top5": em.get("top5", 0.0),
               "group_sparsity": sm["group_sparsity"],
               "avg_wt_bit": avg_bits}
        history.append(rec)
        # train.py:504-515 scalars
        writer.add_scalars(rec, step=epoch)
        writer.flush()
        print(f"[epoch {epoch}] loss {tm['loss']:.4f} acc {tm['acc']:.3f} "
              f"val_top1 {em['top1']:.3f} sparsity "
              f"{sm['group_sparsity']:.3f} avg_bits {avg_bits:.2f}")
        if em["top1"] > best_top1:
            best_top1 = em["top1"]
            save_checkpoint(os.path.join(args.out_dir, "best"), params,
                            opt.state_dict(), {"epoch": epoch, **em})
        if args.save_freq and (epoch + 1) % args.save_freq == 0:
            save_checkpoint(
                os.path.join(args.out_dir, f"ckpt_step_{opt.num_steps}"),
                params, opt.state_dict(), {"epoch": epoch})

    save_checkpoint(os.path.join(args.out_dir, "final"), params,
                    opt.state_dict(), {"epochs": args.epochs})

    # ---- compression + report (train.py:534-617) ----
    full = {
        "macs": oto.compute_macs(params),
        "bops": oto.compute_bops(params),
        "params": oto.compute_num_params(params),
        "weight_bits": oto.compute_weight_size(params),
    }
    new_model, new_params = oto.construct_subnet(params)
    oto2 = OTO(new_model, new_params)
    comp = {
        "macs": oto2.compute_macs(new_params),
        "bops": oto2.compute_bops(new_params),
        "params": oto2.compute_num_params(new_params),
        "weight_bits": oto2.compute_weight_size(new_params),
    }
    print(f"[compress] MACs {full['macs']/1e6:.1f}M -> "
          f"{comp['macs']/1e6:.1f}M | BOPs {full['bops']/1e9:.2f}G -> "
          f"{comp['bops']/1e9:.2f}G | params {full['params']/1e6:.2f}M -> "
          f"{comp['params']/1e6:.2f}M")
    bit_dict = opt.bitwidth_dict(params)
    for lp, bits in sorted(bit_dict.items()):
        print(f"  [bits] {lp}: {bits}")

    import dataclasses as _dc

    save_checkpoint(os.path.join(args.out_dir, "compressed"), new_params,
                    None, {"subnet": _dc.asdict(new_model.cfg),
                           "bit_dict": bit_dict})
    with open(os.path.join(args.out_dir, "history.json"), "w") as f:
        json.dump({"history": history, "full": full, "compressed": comp,
                   "best_top1": best_top1}, f, indent=1)
    writer.close()
    return history


if __name__ == "__main__":
    from ._common import enable_compile_cache

    enable_compile_cache()
    main()
