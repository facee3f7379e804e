"""Numerical guards: the JAX analogue of the reference's NaN forensics.

The reference raises NanInGradientError inside quantizer backward
(quant_layers.py:10-14, 108-123) and sys.exit(1)s on non-finite loss
(utils.py:311-313). Device-side raising doesn't exist under jit, so here the
guards are explicit host checks the driver calls at step/epoch boundaries —
one fused device reduction each, no per-tensor sync.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class NonFiniteLossError(RuntimeError):
    """Raised by the training loop when the loss goes NaN/Inf
    (utils.py:311-313 analogue — raise instead of sys.exit so callers can
    checkpoint-and-abort)."""


def all_finite(tree) -> jax.Array:
    """Single bool scalar: every leaf of ``tree`` is finite. Jit-safe."""
    leaves = [jnp.all(jnp.isfinite(x)) for x in jax.tree.leaves(tree)
              if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)]
    if not leaves:
        return jnp.bool_(True)
    return jnp.all(jnp.stack(leaves))


def assert_tree_finite(tree, what: str = "tree"):
    """Host-side check; raises NonFiniteLossError naming the bad leaves."""
    if bool(all_finite(tree)):
        return
    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if (hasattr(leaf, "dtype")
                and jnp.issubdtype(leaf.dtype, jnp.floating)
                and not bool(jnp.all(jnp.isfinite(leaf)))):
            bad.append(jax.tree_util.keystr(path))
    raise NonFiniteLossError(f"non-finite values in {what}: {bad[:10]}")
