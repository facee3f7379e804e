"""End-to-end accuracy rehearsal: train -> (prune) -> export -> INT top-1.

An executable stand-in for the reference's ImageNet claim (the 0.1% top-1
target in BASELINE.md), upgraded per VERDICT r2 #3 to carry statistical
weight:

- **2,000-sample test set**: one top-1 flip = 0.05%, so the <=0.1% bound
  is a measurable quantum, not an exact-parity assertion in disguise.
- **harder task**: 32x32, 10 classes, 4-block patch-8 ViT
  (vit_small_test). Class k adds template T_k over sigma-1 noise — every
  token carries signal, so the patch-embed + attention stack must
  integrate globally.
- **the reference's actual recipe**: float pretrain -> quantize-wrap ->
  GETA QAT fine-tune (train.py:236-250 starts from ImageNet-21k weights
  and wraps them; nobody trains fake-quant ViT from scratch), driven
  through the real CLI (--weights).
- **a pruning leg**: a second QAT run with target_group_sparsity > 0 ->
  construct_subnet -> export -> INT serving, so GETA pruning ->
  compression -> serving is covered end-to-end by one accuracy number.
"""

import os
import pickle

import numpy as np
import pytest

pytestmark = pytest.mark.slow

CLASSES = 10
IMG = 32
PATCH = 8
N_TRAIN = 512
N_TEST = 2000


def _make_task(rng, n, templates):
    labels = rng.integers(0, CLASSES, n)
    images = (rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32)
              + templates[labels])
    return images.astype(np.float32), labels


def _float_pretrain(tr_x, tr_y, epochs=16):
    """Phase 1: plain-adam float training (the stand-in for the reference's
    ImageNet-21k checkpoint, train.py:236-245)."""
    import flax
    import jax
    import jax.numpy as jnp
    import optax

    from quantized_vit_tpu.models import QuantConfig, VisionTransformer
    from quantized_vit_tpu.models.vit import ViTConfig

    cfg = ViTConfig(img_size=IMG, patch_size=PATCH, embed_dim=64, depth=4,
                    num_heads=4, num_classes=CLASSES,
                    quant=QuantConfig.off())
    model = VisionTransformer(cfg)
    params = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(0),
                   jnp.zeros((1, IMG, IMG, 3), jnp.float32))["params"])
    tx = optax.adam(2e-3)
    state = tx.init(params)

    @jax.jit
    def step(p, s, xb, yb):
        def loss_fn(p):
            logits = model.apply({"params": p}, xb)
            oh = jax.nn.one_hot(yb, CLASSES)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * oh, -1))
        _, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    bs = 64
    for ep in range(epochs):
        idx = np.random.default_rng(ep).permutation(len(tr_x))
        for i in range(0, len(tr_x), bs):
            b = idx[i:i + bs]
            params, state = step(params, state, jnp.asarray(tr_x[b]),
                                 jnp.asarray(tr_y[b]))
    return jax.device_get(params)


def _merge_into_quant_tree(float_params):
    """Phase 2 seed: float weights into the quant model tree + LSFQ init
    at 8 bits (model_to_quantize_model + initialize_quant_layer,
    quant_layers.py:413-440)."""
    import flax
    import jax
    import jax.numpy as jnp

    from quantized_vit_tpu.models import (QuantConfig, VisionTransformer,
                                          init_quant_params_tree)
    from quantized_vit_tpu.models.vit import ViTConfig

    cfg = ViTConfig(img_size=IMG, patch_size=PATCH, embed_dim=64, depth=4,
                    num_heads=4, num_classes=CLASSES,
                    quant=QuantConfig(enabled=True))
    model = VisionTransformer(cfg)
    qp = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(0),
                   jnp.zeros((1, IMG, IMG, 3), jnp.float32))["params"])

    def merge(qnode, fnode):
        for k, v in fnode.items():
            if isinstance(v, dict):
                merge(qnode[k], v)
            else:
                qnode[k] = v

    merge(qp, float_params)
    return init_quant_params_tree(qp, init_bits=8.0)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """ONE task + float pretrain shared by BOTH QAT legs (VERDICT r4 #4:
    the duplicated 25-epoch pretrain dominated the slow tier). Both legs
    used seed-0 task + identical pretrain already; this just computes it
    once."""
    tmp_root = tmp_path_factory.mktemp("acc_e2e_pre")
    rng = np.random.default_rng(0)
    templates = rng.standard_normal((CLASSES, IMG, IMG, 3)).astype(
        np.float32)
    tr_x, tr_y = _make_task(rng, N_TRAIN, templates)
    te_x, te_y = _make_task(rng, N_TEST, templates)
    npz = str(tmp_root / "task.npz")
    np.savez(npz, train_images=tr_x, train_labels=tr_y,
             test_images=te_x, test_labels=te_y)
    fparams = _float_pretrain(tr_x, tr_y)
    with open(str(tmp_root / "float_params.pkl"), "wb") as f:
        pickle.dump(fparams, f)
    return tmp_root, npz, fparams, te_x, te_y


def _train(tmp_root, npz, fparams, sparsity: float):
    from quantized_vit_tpu.cli.train import main
    from quantized_vit_tpu.opt.checkpoint import save_checkpoint

    qinit = _merge_into_quant_tree(fparams)
    save_checkpoint(str(tmp_root / "qat_init"), qinit, None,
                    {"phase": "float-pretrained"})

    out = str(tmp_root / "run")
    main([
        "--model", "vit_small_test", "--dataset", "npz", "--data-path", npz,
        "--img-size", str(IMG), "--num-classes", str(CLASSES),
        "--batch-size", "32", "--epochs", "6", "--lr", "5e-4",
        "--lr-quant", "1e-4", "--weights", str(tmp_root / "qat_init"),
        "--max-bit", "8", "--min-bit", "4",
        "--variant", "adam",
        "--projection-start-epochs", "1", "--projection-epochs", "2",
        "--projection-periods", "4", "--pruning-epochs", "2",
        "--pruning-periods", "2", "--bit-reduction", "1",
        "--target-group-sparsity", str(sparsity),
        "--out-dir", out, "--seed", "0",
    ])
    return out


@pytest.fixture(scope="module")
def trained(pretrained, tmp_path_factory):
    tmp_root, npz, fparams, te_x, te_y = pretrained
    out = _train(tmp_path_factory.mktemp("acc_e2e"), npz, fparams,
                 sparsity=0.0)
    return out, te_x, te_y


@pytest.fixture(scope="module")
def trained_pruned(pretrained, tmp_path_factory):
    tmp_root, npz, fparams, te_x, te_y = pretrained
    out = _train(tmp_path_factory.mktemp("acc_e2e_prune"), npz, fparams,
                 sparsity=0.3)
    return out, te_x, te_y


def _top1(logits, labels):
    return float((np.argmax(logits, -1) == labels).mean())


def _batched_apply(fn, x, bs=250):
    import jax.numpy as jnp

    outs = [np.asarray(fn(jnp.asarray(x[i:i + bs])))
            for i in range(0, len(x), bs)]
    return np.concatenate(outs, 0)


def test_int_path_top1_within_0p1pct(trained):
    from quantized_vit_tpu.cli.eval import load_model_for_eval
    from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

    out, te_x, te_y = trained

    class A:
        checkpoint = os.path.join(out, "final")
        model = "vit_small_test"
        img_size = IMG
        num_classes = CLASSES
        fp32 = False

    model, params = load_model_for_eval(A)
    cfg = model.cfg

    y_fake = _batched_apply(
        lambda xb: model.apply({"params": params}, xb), te_x)
    top1_fake = _top1(y_fake, te_y)
    # the training run must actually have learned the task, else the delta
    # assertion is vacuous
    assert top1_fake >= 0.90, f"QAT failed to converge: {top1_fake}"

    art = export_vit_int4(cfg, params)
    y_int = _batched_apply(
        lambda xb: vit_int4_forward(art, xb, cfg), te_x)
    top1_int = _top1(y_int, te_y)
    assert abs(top1_int - top1_fake) <= 1e-3 + 1e-9, (
        f"INT path top-1 {top1_int} vs fake-quant {top1_fake} "
        f"({N_TEST} samples)")

    # int8 attention: dynamic-quantized score/AV matmuls change numerics;
    # the serving default documents <=1% top-1 drift at this scale
    y_ia = _batched_apply(
        lambda xb: vit_int4_forward(art, xb, cfg, int_attention=True), te_x)
    top1_ia = _top1(y_ia, te_y)
    assert abs(top1_ia - top1_fake) <= 0.01 + 1e-9, (
        f"int8-attention top-1 {top1_ia} vs fake-quant {top1_fake}")


def test_pruned_subnet_int_path_top1_within_0p1pct(trained_pruned):
    """GETA pruning -> construct_subnet -> export -> INT serving, one
    accuracy number end to end (VERDICT r2 #3; mirrors the reference's
    train.py:534-611 construct_subnet + RESULT_TEST.py flow)."""
    from quantized_vit_tpu.cli._common import load_params_any
    from quantized_vit_tpu.cli.eval import vit_config_from_dict
    from quantized_vit_tpu.models.vit import VisionTransformer
    from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

    out, te_x, te_y = trained_pruned

    params, _, extra = load_params_any(os.path.join(out, "compressed"))
    assert "subnet" in extra, "train CLI did not save the compressed subnet"
    cfg = vit_config_from_dict(extra["subnet"])
    model = VisionTransformer(cfg)

    y_fake = _batched_apply(
        lambda xb: model.apply({"params": params}, xb), te_x)
    top1_fake = _top1(y_fake, te_y)
    assert top1_fake >= 0.85, (
        f"pruned subnet lost the task: {top1_fake} (sparsity leg vacuous)")

    art = export_vit_int4(cfg, params)
    y_int = _batched_apply(
        lambda xb: vit_int4_forward(art, xb, cfg), te_x)
    top1_int = _top1(y_int, te_y)
    assert abs(top1_int - top1_fake) <= 1e-3 + 1e-9, (
        f"pruned INT path top-1 {top1_int} vs fake-quant {top1_fake} "
        f"({N_TEST} samples)")


# ---------------------------------------------------------------------------
# SENSITIVE rehearsal (VERDICT r4 #4): a task where W4A4 measurably hurts
# ---------------------------------------------------------------------------

ALPHA_HARD = 0.25  # template amplitude: float ~0.6 top-1, W4A4 ~0.52
                   # (calibrated on the CPU)


def _fit(model, params, tr_x, tr_y, epochs, lr):
    import jax
    import jax.numpy as jnp
    import optax

    tx = optax.adam(lr)
    state = tx.init(params)

    @jax.jit
    def step(p, s, xb, yb):
        def loss_fn(p):
            lg = model.apply({"params": p}, xb)
            oh = jax.nn.one_hot(yb, CLASSES)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(lg) * oh, -1))
        _, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for ep in range(epochs):
        idx = np.random.default_rng(ep).permutation(len(tr_x))
        for i in range(0, len(tr_x), 64):
            b = idx[i:i + 64]
            params, state = step(params, state, jnp.asarray(tr_x[b]),
                                 jnp.asarray(tr_y[b]))
    return params


def sensitive_train():
    """Low-SNR task + tight model where 4-bit fake-quant measurably costs
    top-1 (float-vs-W4A4 gap calibrated at ~7% — the regime where 'INT
    path tracks fake-quant within 0.1%' is a falsifiable claim, unlike
    the 99.6%-top-1 easy task where quantization cannot move the
    metric). Recipe mirrors the reference: float pretrain -> 4-bit
    quantize-wrap -> fine-tune."""
    import flax
    import jax
    import jax.numpy as jnp

    from quantized_vit_tpu.models import (QuantConfig, VisionTransformer,
                                          init_quant_params_tree)
    from quantized_vit_tpu.models.vit import ViTConfig

    rng = np.random.default_rng(0)
    templates = rng.standard_normal((CLASSES, IMG, IMG, 3)).astype(
        np.float32)
    labels_tr = rng.integers(0, CLASSES, N_TRAIN)
    tr_x = (rng.standard_normal((N_TRAIN, IMG, IMG, 3)).astype(np.float32)
            + ALPHA_HARD * templates[labels_tr])
    labels_te = rng.integers(0, CLASSES, N_TEST)
    te_x = (rng.standard_normal((N_TEST, IMG, IMG, 3)).astype(np.float32)
            + ALPHA_HARD * templates[labels_te])

    kw = dict(img_size=IMG, patch_size=PATCH, embed_dim=64, depth=2,
              num_heads=2, num_classes=CLASSES)
    cfg_f = ViTConfig(quant=QuantConfig.off(), **kw)
    mf = VisionTransformer(cfg_f)
    pf = flax.core.unfreeze(mf.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"])
    pf = _fit(mf, pf, tr_x, labels_tr, epochs=16, lr=2e-3)

    cfg_q = ViTConfig(quant=QuantConfig(enabled=True), **kw)
    mq = VisionTransformer(cfg_q)
    pq = flax.core.unfreeze(mq.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"])

    def merge(qnode, fnode):
        for k, v in fnode.items():
            if isinstance(v, dict):
                merge(qnode[k], v)
            else:
                qnode[k] = v

    merge(pq, pf)
    pq = init_quant_params_tree(pq, init_bits=4.0)  # W4A4 directly
    pq = _fit(mq, pq, tr_x, labels_tr, epochs=6, lr=5e-4)
    return (mf, pf, cfg_f), (mq, pq, cfg_q), te_x.astype(np.float32), \
        labels_te


@pytest.fixture(scope="module")
def sensitive_trained():
    return sensitive_train()


def test_sensitive_task_w4a4_gap_and_int_tracks_fake_quant(
        sensitive_trained):
    """(a) float vs W4A4 fake-quant top-1 differ MEASURABLY (>= 2%; the
    rehearsal can fail); (b) the INT serving path tracks FAKE-QUANT (not
    float) within 0.1% on the same 2000 samples — the discriminating
    form of the BASELINE.md accuracy bound."""
    from quantized_vit_tpu.serve import export_vit_int4, vit_int4_forward

    (mf, pf, cfg_f), (mq, pq, cfg_q), te_x, te_y = sensitive_trained

    y_float = _batched_apply(
        lambda xb: mf.apply({"params": pf}, xb), te_x)
    top1_float = _top1(y_float, te_y)
    y_fake = _batched_apply(
        lambda xb: mq.apply({"params": pq}, xb), te_x)
    top1_fake = _top1(y_fake, te_y)

    assert top1_float >= 0.5, f"float model failed the task: {top1_float}"
    assert top1_float - top1_fake >= 0.02, (
        f"task not quantization-sensitive: float {top1_float} vs W4A4 "
        f"{top1_fake} — the <=0.1% assertion below would be vacuous")

    art = export_vit_int4(cfg_q, pq)
    y_int = _batched_apply(
        lambda xb: vit_int4_forward(art, xb, cfg_q),
        te_x)
    top1_int = _top1(y_int, te_y)
    assert abs(top1_int - top1_fake) <= 1e-3 + 1e-9, (
        f"INT path top-1 {top1_int} vs fake-quant {top1_fake} on the "
        f"sensitive task (float is {top1_float} — tracking float would "
        "be a REAL failure here)")
