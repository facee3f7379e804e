"""CLI plumbing that runs outside the slow end-to-end drivers: the compile
cache helper, and cli.serve's mesh forward with uint8 input."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_vit_tpu.cli import _common


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory setting after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_the_env_var(monkeypatch, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert _common.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_a_fixed_repo_path(monkeypatch,
                                                     cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = _common.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert _common.enable_compile_cache() == path  # same path every call


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_serve_mesh_input_uint8_scales_pixels(mode):
    """--input-uint8 with --mesh-model: the mesh forward must scale the
    0-255 pixels like the single-device forward does."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh")
    from quantized_vit_tpu.artifact.vit import save_vit_int4_artifact
    from quantized_vit_tpu.cli import serve as serve_cli
    from quantized_vit_tpu.configs import ViTConfig
    from quantized_vit_tpu.serve import random_vit_int4_artifact
    from quantized_vit_tpu.utils.native_prep import patchify_batch

    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=2, num_classes=10)
    art = random_vit_int4_artifact(cfg, seed=0)
    images = np.random.default_rng(0).integers(
        0, 256, (4, 32, 32, 3)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        save_vit_int4_artifact(d, art, cfg)
        args = serve_cli.parse_args(["--artifact", d, "--mesh-model", "2",
                                     "--mesh-mode", mode, "--input-uint8"])
        forward, _, _ = serve_cli.build_forward(args)
    got = forward(images)

    def mesh_forward(x):
        xs = jax.device_put(patchify_batch(x, cfg.patch_size),
                            forward.x_sharding)
        return np.asarray(forward.fwd_fn(
            forward.artifact, xs, cfg, forward.mesh,
            float_dtype=jnp.bfloat16, images_layout="patches"), np.float32)

    scaled = images.astype(np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(got, mesh_forward(scaled))
    assert np.abs(got - mesh_forward(images.astype(np.float32))).max() > 0.1
