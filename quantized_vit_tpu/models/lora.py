"""LoRA adapters with pruning-graph support.

Reference: the vendored OTO library ships LoRA-aware operators
(operator.py:521-674 LoraLinearOTO / LoraEmbeddingOTO) and LoRA importance
variants (importance_score/taylor.py:43-107): the frozen base weight can't
supply gradient saliency, so the Taylor/cosine criteria use the low-rank
product B.A as the gradient proxy against the original weight; lora_A is
NO_PRUNE, lora_B prunes out-rows together with the base weight; subnet
construction can merge the adapter into the base (pruning_compression.py's
LoRA merge export).

Layout (flax): ``kernel [in, out]``, ``lora_a [in, r]``,
``lora_b [r, out]``; forward ``y = x@kernel + (alpha/r) * (x@lora_a)@lora_b
(+ bias)``. Freezing is the optimizer's concern in JAX — use
:func:`lora_grad_mask` with ``optax.masked`` or zero the base grads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp


class LoraDense(nn.Module):
    """Dense layer with a low-rank adapter (lora_B init zero, so the
    adapted layer starts exactly equal to the base)."""

    features: int
    rank: int = 8
    alpha: float = 16.0
    use_bias: bool = True
    kernel_init: Any = nn.initializers.lecun_normal()

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @nn.compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        lora_a = self.param("lora_a", nn.initializers.normal(stddev=0.02),
                            (x.shape[-1], self.rank), jnp.float32)
        lora_b = self.param("lora_b", nn.initializers.zeros,
                            (self.rank, self.features), jnp.float32)
        y = x @ kernel + self.scaling * ((x @ lora_a) @ lora_b)
        if self.use_bias:
            y = y + self.param("bias", nn.initializers.zeros,
                               (self.features,), jnp.float32)
        return y


class LoraEmbedding(nn.Module):
    """Embedding with a low-rank adapter (LoraEmbeddingOTO,
    operator.py:592-674). Base table ``embedding [vocab, dim]`` plus
    ``lora_a [vocab, r]`` / ``lora_b [r, dim]``; the adapted lookup is
    ``embedding[ids] + (alpha/r) * lora_a[ids] @ lora_b`` — exactly
    ``one_hot(ids) @ (E + s*A@B)`` without materializing the one-hot.
    lora_a init zero here (the table side), so the adapted layer starts
    equal to the base, mirroring the zero-init-B convention of LoraDense."""

    num_embeddings: int
    features: int
    rank: int = 8
    alpha: float = 16.0

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @nn.compact
    def __call__(self, ids):
        embedding = self.param(
            "embedding", nn.initializers.normal(stddev=0.02),
            (self.num_embeddings, self.features), jnp.float32)
        lora_a = self.param("lora_a", nn.initializers.zeros,
                            (self.num_embeddings, self.rank), jnp.float32)
        lora_b = self.param("lora_b", nn.initializers.normal(stddev=0.02),
                            (self.rank, self.features), jnp.float32)
        return (jnp.take(embedding, ids, axis=0)
                + self.scaling * (jnp.take(lora_a, ids, axis=0) @ lora_b))


def merge_lora(params, scaling_by_path: Optional[dict] = None,
               default_scaling: float = 2.0):
    """Fold every adapter into its base weight: base += scaling * A @ B,
    dropping the lora params (the reference's LoRA-merge export option,
    pruning_compression.py:374-391). Handles both Dense (``kernel``) and
    Embedding (``embedding``) bases — A @ B is [in, out] / [vocab, dim] in
    either layout. Returns a new pytree."""

    def visit(node, path=""):
        if not isinstance(node, dict):
            return node
        out = {k: visit(v, f"{path}/{k}" if path else k)
               for k, v in node.items()}
        if "lora_a" in out and "lora_b" in out:
            base_key = "kernel" if "kernel" in out else (
                "embedding" if "embedding" in out else None)
            if base_key is not None:
                s = (scaling_by_path or {}).get(path, default_scaling)
                out[base_key] = (out[base_key]
                                 + s * (out["lora_a"] @ out["lora_b"]))
                del out["lora_a"], out["lora_b"]
        return out

    return visit(params)


def lora_grad_mask(params):
    """Boolean pytree: True for trainable (lora_a/lora_b) leaves, False for
    everything else — the functional analogue of the reference's
    requires_grad freezing. Feed to optax.masked or multiply into grads."""

    def visit(node, in_lora_layer):
        if not isinstance(node, dict):
            return False
        has_lora = "lora_a" in node and "lora_b" in node
        return {
            k: (k in ("lora_a", "lora_b") if has_lora and not isinstance(v, dict)
                else visit(v, has_lora))
            for k, v in node.items()
        }

    return visit(params, False)
