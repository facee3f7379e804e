"""The float32 reference of the serving forward (serve/reference.py): pinned
to the flax fake-quant VisionTransformer, and the integer serving forward
checked against it — the comparison chip_smoke.py makes on the card.
"""

import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantized_vit_tpu.models import (
    QuantConfig,
    ViTConfig,
    VisionTransformer,
    init_quant_params_tree,
)
from quantized_vit_tpu.serve import (export_vit_int4, vit_int4_forward,
                                     vit_reference_forward)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build(init_bits, nonlinear=True, batch=4, seed=0):
    cfg = ViTConfig(quant=QuantConfig(enabled=True, nonlinear=nonlinear),
                    **SMALL)
    model = VisionTransformer(cfg)
    x = jnp.array(
        np.random.default_rng(seed).standard_normal((batch, 32, 32, 3)),
        jnp.float32)
    params = flax.core.unfreeze(model.init(jax.random.PRNGKey(0), x)["params"])
    params = init_quant_params_tree(params, init_bits=init_bits)
    return cfg, model, params, x


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("init_bits", [4.0, 8.0])
@pytest.mark.parametrize("nonlinear", [True, False])
def test_reference_matches_flax_fake_quant(init_bits, nonlinear):
    """Dequantized weights, LSFQ activation fake-quant, float LayerNorm /
    softmax / exact GELU: the reference is the flax fake-quant forward."""
    cfg, model, params, x = _build(init_bits, nonlinear)
    y_fake = np.asarray(model.apply({"params": params}, x))
    art = export_vit_int4(cfg, params)
    y_ref = np.asarray(vit_reference_forward(art, x, cfg))
    np.testing.assert_allclose(y_ref, y_fake, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("float_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 4])
def test_int_forward_matches_reference(fmt, float_dtype, batch):
    """The integer forward against the float reference, in both weight
    formats (4-bit export packs int4; 8-bit stays int8) and residual dtypes.
    f32 agrees to f32 rounding; bf16 rounds the residual stream, which
    flips some 8-bit activation levels (measured 4.6e-3 here)."""
    cfg, _, params, x = _build(4.0 if fmt == "int4" else 8.0, batch=batch)
    art = export_vit_int4(cfg, params)
    assert art["blocks"][0]["fc1"].fmt == fmt
    y = vit_int4_forward(art, x, cfg, float_dtype=jnp.dtype(float_dtype))
    err = _rel_l2(y, vit_reference_forward(art, x, cfg))
    assert err <= (1e-5 if float_dtype == "float32" else 2e-2), err


def test_serving_imports_without_flax_orbax_torch():
    """The serving modules, the ViT artifact and cli.serve import, and a
    tiny forward runs, with flax, orbax and torch unimportable."""
    code = """
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "torch"):
    sys.modules[name] = None
import jax.numpy as jnp
import numpy as np
import quantized_vit_tpu.serve
import quantized_vit_tpu.serve.vit_tp
import quantized_vit_tpu.serve.vit_fsdp
import quantized_vit_tpu.serve.batching
import quantized_vit_tpu.artifact.vit
import quantized_vit_tpu.cli.serve
import quantized_vit_tpu.utils.native_prep
from quantized_vit_tpu.configs import ViTConfig
from quantized_vit_tpu.serve import (random_vit_int4_artifact,
                                     vit_int4_forward, vit_reference_forward)
cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                num_heads=2, num_classes=10)
art = random_vit_int4_artifact(cfg, seed=0)
x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 32, 32, 3)),
                jnp.float32)
y = vit_int4_forward(art, x, cfg)
r = vit_reference_forward(art, x, cfg)
assert y.shape == r.shape == (2, 10)
assert not any(m in sys.modules and sys.modules[m] is not None
               for m in ("flax", "orbax", "torch"))
print("FLAX_FREE_OK")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FLAX_FREE_OK" in out.stdout
