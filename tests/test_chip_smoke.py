"""chip_smoke.py's phases at a tiny ViT on the CPU device (the card run
itself is marked ``gpu``), its refusal to run without a GPU, and the
full-width CPU measurement its reference bounds were fixed from."""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from quantized_vit_tpu.configs import ViTConfig
from quantized_vit_tpu.serve import vit_int4

TINY = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                 num_heads=4, num_classes=10)


@pytest.fixture(scope="module")
def tiny():
    arts = cs.make_artifacts(TINY, 0)
    patches = cs.make_patches(TINY, 8, 0)
    cpu = jax.devices("cpu")[0]
    logits, _ = cs.run_forwards(arts, patches, TINY, cpu)
    return arts, patches, logits, cpu


@pytest.fixture
def gpu():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {devices[0].platform}")
    return devices


def test_main_refuses_a_non_gpu_platform(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert "needs a GPU" in str(e.value)
    assert '"ok"' not in capsys.readouterr().out


def test_run_forwards_shapes_and_formats(tiny):
    arts, patches, logits, _ = tiny
    assert set(logits) == {(f, d, b) for f in ("int8", "int4")
                           for d, b in (("bfloat16", 8), ("float32", 8),
                                        ("bfloat16", 1))}
    for y in logits.values():
        assert y.shape[1] == TINY.num_classes and np.isfinite(y).all()
    # same seed -> same levels in both storage formats
    np.testing.assert_array_equal(logits[("int8", "float32", 8)],
                                  logits[("int4", "float32", 8)])


def test_stage_errors_cover_every_stage(tiny):
    arts, patches, logits, cpu = tiny
    errs = cs.stage_errors(arts["int4"], patches[:4], TINY, "float32", cpu,
                           cpu)
    assert [n for n, _ in errs] == (["embedding"] + [
        f"block {i} {half}" for i in range(TINY.depth)
        for half in ("attn", "mlp")] + ["head"])
    assert all(e == 0.0 for _, e in errs)
    assert cs.check_cpu_parity(arts, patches, logits, TINY, cpu, cpu) == {
        "int8": 0.0, "int4": 0.0}


def test_reference_errors_within_bounds(tiny):
    arts, patches, logits, cpu = tiny
    errs = cs.reference_errors(arts, patches, logits, TINY, cpu, cpu,
                               bounds=cs.REFERENCE_BOUND)
    assert set(errs) == set(cs.REFERENCE_BOUND)
    assert errs[("int8", "float32")] < 1e-5


def test_reference_errors_fail_past_a_bound(tiny):
    arts, patches, logits, cpu = tiny
    bounds = dict(cs.REFERENCE_BOUND)
    bounds[("int4", "bfloat16")] = 1e-9
    with pytest.raises(RuntimeError, match="check \\(b\\) int4 bfloat16"):
        cs.reference_errors(arts, patches, logits, TINY, cpu, cpu,
                            bounds=bounds)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_stage_errors_catch_unmasked_pad_keys(dtype, monkeypatch):
    """An int path whose attention forgets to mask the pad keys fails (b)
    at the first attention half, in either residual dtype."""
    patches = cs.make_patches(TINY, 8, 0)
    art = cs.make_artifacts(TINY, 0)["int8"]
    cpu = jax.devices("cpu")[0]
    attention = vit_int4.attention_qkv_xla
    monkeypatch.setattr(vit_int4, "attention_qkv_xla",
                        lambda qkv, **kw: attention(qkv, **{**kw,
                                                            "n_valid": None}))
    errs = dict(cs.reference_stage_errors(art, patches, TINY, dtype, cpu,
                                          cpu))
    assert errs["embedding"] < cs.REFERENCE_BOUND[("int8", dtype)]
    assert errs["block 0 attn"] > cs.REFERENCE_BOUND[("int8", dtype)]


def test_int_and_reference_rows_round_trip():
    x = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    rows = cs._int_rows(x, 16)
    assert rows.shape == (32, 3)
    np.testing.assert_array_equal(rows.reshape(2, 16, 3)[:, 4], x[:, 0])
    np.testing.assert_array_equal(rows.reshape(2, 16, 3)[:, 5:], 0.0)
    np.testing.assert_array_equal(cs._ref_rows(rows, 2, 5), x)


@pytest.mark.parametrize("input_uint8", [True, False])
def test_served_phase_answers_match_direct_forward(tiny, input_uint8):
    arts = tiny[0]
    assert cs.served_phase(TINY, arts["int8"], input_uint8, 12, 0) == 0.0


def test_timing_phase_reports_both_formats_and_batches(tiny):
    arts, patches, _, cpu = tiny
    out = cs.timing_phase(arts, patches, TINY, cpu, "cpu")
    assert set(out) == {(f, b) for f in ("int8", "int4") for b in (8, 1)}
    for med, lo, hi in out.values():
        assert lo <= med <= hi


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_four_card_phase_on_the_cpu_mesh(tiny, mode):
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh")
    out = cs.four_card_phase(TINY, tiny[0]["int4"], 4, mode, 0, batch=8)
    if mode == "tp":
        assert out["block_max_rel_l2"] <= cs.CPU_PARITY_BOUND
    else:
        assert out["f32_max_abs"] <= cs.MESH_F32_ATOL


def test_optional_imports_reports_each_package():
    out = cs.optional_imports()
    assert set(out) == {"flax", "orbax.checkpoint", "torch"}
    assert out["flax"] == "imports"


@pytest.mark.slow
def test_reference_bounds_are_twice_the_cpu_error():
    """The (b) bounds: the int path against the float reference, both on
    the CPU, stage by stage at ViT-B/16 and seed 0 on all BATCH images;
    each bound is twice the largest stage error (never below 1e-4), to
    the three digits it is written with."""
    cfg = cs.vit_b16()
    arts = cs.make_artifacts(cfg, 0)
    patches = cs.make_patches(cfg, cs.BATCH, 0)
    cpu = jax.devices("cpu")[0]
    errs = cs.reference_errors(arts, patches, None, cfg, cpu, cpu)
    for key, err in errs.items():
        want = max(2 * err, 1e-4)
        assert want <= cs.REFERENCE_BOUND[key] <= 1.01 * want, (key, err)


@pytest.mark.gpu
def test_smoke_on_the_card(gpu, capsys):
    """The whole one-card smoke (python -m pytest -m gpu on the card)."""
    assert cs.main([]) == 0
    assert '"ok": true' in capsys.readouterr().out
