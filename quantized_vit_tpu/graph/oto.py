"""OTO facade: the one-stop user API over graph / optimizer / compression.

Reference: only_train_once/__init__.py:10-444 (`class OTO`): wraps graph
construction, optimizer factories (`.geta`, `.hesso`), subnet construction,
cost metrics and unprunable marking. The JAX facade takes a flax
module + params pytree instead of a torch module + dummy input — node groups
come from the declarative builders (graph/builders.py) instead of a
torch.jit trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..models.autoencoder import ConvAutoencoder
from ..models.mobilenet import MobileNet
from ..models.resnet import ResNet
from ..models.transformer import TransformerEncoder
from ..models.ultranet import UltraNet
from ..models.vit import ViTConfig, VisionTransformer
from ..opt import (GETA, GETAConfig, HESSO, HESSOConfig, HESSOCRIC,
                   HESSOCRICConfig, NodeGroup)
from .builders import (autoencoder_node_groups, mark_unprunable,
                       mobilenet_node_groups, resnet_node_groups,
                       transformer_node_groups, ultranet_node_groups,
                       vit_node_groups)
from .costs import (autoencoder_cost_report, mobilenet_cost_report,
                    resnet_cost_report,
                    transformer_cost_report,
                    ultranet_cost_report, vit_cost_report)


class OTO:
    """Facade over node groups + GETA/HESSO + compression + cost metrics.

    Usage (train.py:333-410 analogue)::

        oto = OTO(model, params)
        oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed", "head"])
        opt = oto.geta(lr=1e-4, target_group_sparsity=0.5, ...)
        ... training loop: params = opt.step(params, grads) ...
        new_model, new_params = oto.construct_subnet(params)
    """

    def __init__(self, model, params, batch_stats=None, example_input=None,
                 model_kwargs=None):
        self.model = model
        self.params = params
        self.batch_stats = batch_stats
        self._example_input = example_input
        self._model_kwargs = model_kwargs
        if isinstance(model, VisionTransformer):
            self.kind = "vit"
            self.cfg: ViTConfig = model.cfg
            self.node_groups: List[NodeGroup] = vit_node_groups(
                self.cfg, params)
        elif isinstance(model, UltraNet):
            self.kind = "ultranet"
            self.cfg = None
            self.node_groups = ultranet_node_groups(params)
        elif isinstance(model, MobileNet):
            self.kind = "mobilenet"
            self.cfg = model.cfg
            self.node_groups = mobilenet_node_groups(self.cfg, params)
        elif isinstance(model, ResNet):
            self.kind = "resnet"
            self.cfg = model.cfg
            self.node_groups = resnet_node_groups(self.cfg, params)
        elif isinstance(model, TransformerEncoder):
            self.kind = "transformer"
            self.cfg = model.cfg
            self.node_groups = transformer_node_groups(self.cfg, params)
        elif isinstance(model, ConvAutoencoder):
            self.kind = "autoencoder"
            self.cfg = model.cfg
            self.node_groups = autoencoder_node_groups(self.cfg, params)
        elif example_input is not None:
            # unknown family: automatic pzig discovery from the jaxpr
            # (autogroups.py — the reference's basic-module partition,
            # pruning_dependency.py steps 1-10; composed/attention models
            # should use their declarative builders instead)
            from .autogroups import discover_node_groups

            self.kind = "auto"
            self.cfg = getattr(model, "cfg", None)
            self.node_groups, self.group_edges, self._auto_plan = (
                discover_node_groups(
                    model, params, example_input, batch_stats=batch_stats,
                    model_kwargs=model_kwargs, return_edges=True,
                    return_plan=True))
        else:
            raise ValueError(
                f"no node-group builder registered for {type(model).__name__};"
                " pass example_input= for automatic discovery, or pass "
                "groups explicitly to GETA/HESSO")
        self._optimizer = None

    # ------------------------------------------------------------------
    # graph-side controls
    # ------------------------------------------------------------------

    def mark_unprunable_by_param_names(self, names: Sequence[str]):
        """__init__.py:403-413."""
        mark_unprunable(self.node_groups, list(names))

    # ------------------------------------------------------------------
    # optimizer factories (__init__.py:88-176)
    # ------------------------------------------------------------------

    def geta(self, **kwargs) -> GETA:
        cfg = GETAConfig(**kwargs)
        self._optimizer = GETA(self.node_groups, self.params, cfg)
        return self._optimizer

    def hesso(self, **kwargs) -> HESSO:
        cfg = HESSOConfig(**kwargs)
        self._optimizer = HESSO(self.node_groups, self.params, cfg)
        return self._optimizer

    def hesso_cric(self, **kwargs) -> HESSOCRIC:
        """Cyclic redundancy identification variant (hesso_cric.py:7-407);
        pass the loss into ``step(params, grads, loss=...)``."""
        cfg = HESSOCRICConfig(**kwargs)
        self._optimizer = HESSOCRIC(self.node_groups, self.params, cfg)
        return self._optimizer

    # ------------------------------------------------------------------
    # compression (__init__.py:361-398)
    # ------------------------------------------------------------------

    def construct_subnet(self, params=None, batch_stats=None,
                         model_builder=None):
        """Slice the group-sparse net into a dense subnet. Returns
        (new_model, new_params) for ViT and
        (new_model, new_params, new_batch_stats) for UltraNet.

        For auto-discovered models (kind == 'auto'): the in-dim links come
        from the discovery dataflow walk (graph/autogroups.py StemPlan —
        the jaxpr equivalent of the reference's compression-time DFS,
        pruning_compression.py:134-215). Returns
        ``(new_params, shapes[, new_batch_stats])`` where ``shapes`` maps
        each stem layer to its sliced kernel shape; pass ``model_builder``
        (a callable ``shapes -> module``) to get
        ``(new_model, new_params[, new_batch_stats])`` like the family
        paths — flax modules carry static widths, so the architecture
        object must be re-made rather than surgically narrowed in place.
        """
        from ..compress import (construct_subnet_resnet,
                                construct_subnet_ultranet,
                                construct_subnet_vit)

        params = self.params if params is None else params
        if self.kind == "auto":
            from ..compress.auto import construct_subnet_auto

            stats = batch_stats if batch_stats is not None else self.batch_stats
            new_params, shapes, new_stats = construct_subnet_auto(
                params, self.node_groups, self._auto_plan, batch_stats=stats)
            head = (model_builder(shapes),) if model_builder else ()
            tail = (new_stats,) if stats is not None else ()
            if model_builder:
                return head + (new_params,) + tail
            return (new_params, shapes) + tail
        if self.kind == "vit":
            new_cfg, new_params = construct_subnet_vit(
                self.cfg, params, self.node_groups)
            return VisionTransformer(new_cfg), new_params
        if self.kind == "mobilenet":
            from ..compress import construct_subnet_mobilenet

            new_cfg, new_params, new_stats = construct_subnet_mobilenet(
                self.cfg, params, self.node_groups,
                batch_stats if batch_stats is not None else self.batch_stats)
            return MobileNet(new_cfg), new_params, new_stats
        if self.kind == "resnet":
            new_cfg, new_params, new_stats = construct_subnet_resnet(
                self.cfg, params, self.node_groups,
                batch_stats if batch_stats is not None else self.batch_stats)
            return ResNet(new_cfg), new_params, new_stats
        if self.kind == "transformer":
            from ..compress import construct_subnet_transformer

            new_cfg, new_params = construct_subnet_transformer(
                self.cfg, params, self.node_groups)
            return TransformerEncoder(new_cfg), new_params
        if self.kind == "autoencoder":
            from ..compress import construct_subnet_autoencoder

            new_cfg, new_params = construct_subnet_autoencoder(
                self.cfg, params, self.node_groups)
            return ConvAutoencoder(new_cfg), new_params
        channels, new_params, new_stats = construct_subnet_ultranet(
            params, self.node_groups,
            batch_stats if batch_stats is not None else self.batch_stats)
        model = UltraNet(w_bit=self.model.w_bit, a_bit=self.model.a_bit,
                         channels=channels)
        return model, new_params, new_stats

    # ------------------------------------------------------------------
    # cost metrics (__init__.py:415-441)
    # ------------------------------------------------------------------

    def _report(self, params=None) -> Dict[str, Any]:
        params = self.params if params is None else params
        # the compute_* metrics call this back-to-back on the same pytree
        # (and for kind='auto' each report is a full jax trace) — memoize
        # on the pytree object identity
        cached = getattr(self, "_report_cache", None)
        if cached is not None and cached[0] is params:
            return cached[1]
        rep = self._report_uncached(params)
        self._report_cache = (params, rep)
        return rep

    def _report_uncached(self, params) -> Dict[str, Any]:
        if self.kind == "auto":
            from .autogroups import trace_cost_report

            rep = trace_cost_report(
                self.model, params, self._example_input,
                batch_stats=self.batch_stats,
                model_kwargs=self._model_kwargs)
            # weight-size/avg-bit via the generic leaf walk (costs._finish
            # needs the accumulating keys the family reports carry)
            from .costs import _layer_bits, _leaf_sizes

            sizes = _leaf_sizes(params)
            quant_names = ("d_quant", "q_m_", "t_quant")
            num_params = sum(v for k, v in sizes.items()
                             if not any(q in k for q in quant_names))
            bits = 0.0
            counted = 0
            for layer in rep["per_layer"]:
                ksize = sizes.get(f"{layer}/kernel", 0)
                w_bit, _ = _layer_bits(params, layer)
                bits += ksize * w_bit
                counted += ksize
            bits += (num_params - counted) * 32.0
            rep["num_params"] = num_params
            rep["weight_size_bits"] = bits
            rep["average_bit_width"] = bits / max(num_params, 1)
            return rep
        if self.kind == "vit":
            return vit_cost_report(self.cfg, params)
        if self.kind == "mobilenet":
            return mobilenet_cost_report(self.cfg, params)
        if self.kind == "resnet":
            return resnet_cost_report(self.cfg, params)
        if self.kind == "transformer":
            return transformer_cost_report(self.cfg, params)
        if self.kind == "autoencoder":
            return autoencoder_cost_report(self.cfg, params)
        return ultranet_cost_report(params)

    def compute_macs(self, params=None) -> float:
        return self._report(params)["total_macs"]

    def compute_bops(self, params=None) -> float:
        return self._report(params)["total_bops"]

    def compute_num_params(self, params=None) -> int:
        return self._report(params)["num_params"]

    def compute_weight_size(self, params=None) -> float:
        """Total weight bits under learned bit widths."""
        return self._report(params)["weight_size_bits"]

    def compute_average_bit_width(self, params=None) -> float:
        return self._report(params)["average_bit_width"]

    # ------------------------------------------------------------------
    # visualization (__init__.py:62-86)
    # ------------------------------------------------------------------

    def cluster_node_groups(self, num_clusters: int = 1):
        """Cluster prunable node groups by size (graph.py:1653-1684).

        The reference runs sklearn KMeans on [num_groups, 1.0] feature rows;
        here a tiny Lloyd's loop (the feature space is 1-D in practice) keeps
        the dependency surface zero. Returns {cluster_id: [NodeGroup, ...]}.
        """
        import numpy as np

        prunable = [g for g in self.node_groups
                    if g.is_prunable and not g.is_auxiliary]
        if num_clusters <= 1:
            self.node_group_clusters = {0: list(prunable)}
            return self.node_group_clusters
        if len(prunable) <= num_clusters:
            # fewer groups than clusters: singletons (KMeans behavior)
            self.node_group_clusters = {i: [g]
                                        for i, g in enumerate(prunable)}
            return self.node_group_clusters

        sizes = np.array([float(g.num_groups) for g in prunable])
        # deterministic init: evenly spaced quantiles
        centers = np.quantile(sizes, np.linspace(0, 1, num_clusters))
        for _ in range(50):
            labels = np.argmin(np.abs(sizes[:, None] - centers[None, :]),
                               axis=1)
            new = np.array([
                sizes[labels == c].mean() if (labels == c).any() else centers[c]
                for c in range(num_clusters)])
            if np.allclose(new, centers):
                break
            centers = new
        self.node_group_clusters = {}
        for g, lab in zip(prunable, labels):
            self.node_group_clusters.setdefault(int(lab), []).append(g)
        return self.node_group_clusters

    def random_set_zero_groups(self, params=None,
                               target_group_sparsity: Optional[float] = None,
                               num_group_divisible: int = 2, seed: int = 0):
        """Randomly zero whole groups — the reference's sparsity-debugging
        hook used to exercise construct_subnet without training
        (graph.py:1165-1270). Returns a new params pytree."""
        import numpy as np
        import jax.numpy as jnp

        from ..opt.groups import Transform, get_path, group_mask_for_param, \
            set_path

        params = self.params if params is None else params
        rng = np.random.default_rng(seed)
        for g in self.node_groups:
            if not g.is_prunable or g.is_auxiliary:
                continue
            gs = (rng.random() if target_group_sparsity is None
                  else target_group_sparsity)
            assert 0.0 <= gs < 1.0
            n_zero = max(min(int(gs * g.num_groups) // num_group_divisible
                             * num_group_divisible, g.num_groups - 1), 0)
            if n_zero == 0:
                continue
            idx = np.sort(rng.choice(g.num_groups, n_zero, replace=False))
            mask = np.zeros((g.num_groups,), np.float32)
            mask[idx] = 1.0
            mask = jnp.asarray(mask)
            for e in g.entries:
                if e.transform == Transform.NO_PRUNE:
                    continue
                p = get_path(params, e.path)
                m = group_mask_for_param(mask, e.transform, p.shape,
                                         g.num_heads)
                params = set_path(params, e.path, p * (1.0 - m))
        return params

    def visualize(self, out_path: Optional[str] = None) -> str:
        """Emit the node-group structure as Graphviz DOT text. Auto-
        discovered graphs carry REAL dataflow edges (stem -> stem data
        dependencies recorded during discovery); family-declared graphs
        fall back to layout-order invisible edges."""
        lines = ["digraph node_groups {", "  rankdir=TB;",
                 '  node [shape=box, fontname="helvetica"];']
        for g in self.node_groups:
            color = "lightblue" if g.is_prunable else "lightgray"
            label = (f"{g.id}\\n{g.num_groups} groups"
                     f"{' (unprunable)' if not g.is_prunable else ''}")
            lines.append(
                f'  "{g.id}" [label="{label}", style=filled,'
                f' fillcolor={color}];')
        edges = getattr(self, "group_edges", None)
        if edges:
            for a, b in edges:
                lines.append(f'  "{a}" -> "{b}";')
        else:
            ordered = [g.id for g in self.node_groups]
            for a, b in zip(ordered, ordered[1:]):
                lines.append(f'  "{a}" -> "{b}" [style=invis];')
        lines.append("}")
        dot = "\n".join(lines)
        if out_path:
            with open(out_path, "w") as f:
                f.write(dot)
        return dot
